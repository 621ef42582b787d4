// Serial CPU build of the kernels' per-block bodies, for tests only.
//
// g++ compiles the kernels' .cuh bodies here without CUDA, so the test suite
// can hold the kernels' own arithmetic against the plain torch versions on
// a machine without a GPU. The encoder never loads this library.
#include <stddef.h>
#include <stdint.h>

#include "composite.cuh"
#include "filter.cuh"
#include "merge.cuh"
#include "pack.cuh"

extern "C" void pack_blocks_aligned_host(const int32_t* codes,
                                         const int32_t* lens,
                                         const int32_t* starts, int32_t* out,
                                         int nb, int n_sym, int n_aw) {
  for (int b = 0; b < nb; ++b) {
    const size_t row = (size_t)b * (size_t)n_sym;
    pack_block(codes + row, lens + row, starts[b], n_sym, n_aw,
               out + (size_t)b * (size_t)n_aw);
  }
}

extern "C" void merge_or_host(const int32_t* local, const int32_t* starts,
                              int32_t* dense, int nb, int n_aw, int n_words) {
  for (int b = 0; b < nb; ++b) {
    merge_block(local + (size_t)b * (size_t)n_aw, starts[b], n_aw, n_words,
                (uint32_t*)dense);
  }
}

extern "C" void filter_select_host(const uint8_t* band, const uint8_t* prev,
                                   uint8_t* filtered, uint8_t* types, int h,
                                   int n, int bpp, int swap) {
  for (int r = 0; r < h; ++r) {
    const uint8_t* raw = band + (size_t)r * (size_t)n;
    types[r] = (uint8_t)filter_row_serial(raw, swap, r ? raw - n : prev,
                                          r ? swap : 0, n, bpp,
                                          filtered + (size_t)r * (size_t)n);
  }
}

extern "C" int composite_segments_host(const int64_t* metas, int s_count,
                                       const uint8_t* srcs,
                                       const uint8_t* bg, uint8_t* out, int h,
                                       int w) {
  int ties = 0;
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      ties += composite_pixel(y, x, metas, s_count, srcs, bg,
                              out + ((size_t)y * (size_t)w + (size_t)x) * 4);
    }
  }
  return ties;
}
