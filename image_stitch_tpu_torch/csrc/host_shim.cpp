// Serial CPU build of the kernels' per-block bodies, for tests only.
//
// g++ compiles the kernels' .cuh bodies here without CUDA, so the test suite
// can hold the kernels' own arithmetic against the plain torch versions on
// a machine without a GPU. The encoder never loads this library.
#include <stddef.h>
#include <stdint.h>

#include "composite.cuh"
#include "filter.cuh"
#include "pack_merge.cuh"

// The pairs of each block run in order with a running sum of their lengths:
// the serial chain that the kernel's warp scan reproduces.
extern "C" void pack_merge_host(const int32_t* codes, const int32_t* lens,
                                const int32_t* starts, int32_t* dense, int nb,
                                int n_sym, int n_aw, int n_words) {
  uint32_t stage[PACK_MAX_AW];
  for (int b = 0; b < nb; ++b) {
    const size_t row = (size_t)b * (size_t)n_sym;
    for (int c = 0; c < n_aw; ++c) stage[c] = 0u;
    int off = starts[b] & 31;
    for (int s = 0; s < n_sym; s += 2) {
      const bool has2 = s + 1 < n_sym;
      const uint32_t c2 = has2 ? (uint32_t)codes[row + s + 1] : 0u;
      const int l2 = has2 ? lens[row + s + 1] : 0;
      off += lens[row + s] + l2;
      const PairWords pw =
          pair_words((uint32_t)codes[row + s], c2, l2, off, n_aw);
      for (int k = 0; k < 3; ++k) stage[pw.idx[k]] |= pw.val[k];
    }
    for (int c = 0; c < n_aw; ++c) {
      const int idx = dense_index(starts[b], c, n_words);
      if (idx >= 0) ((uint32_t*)dense)[idx] += stage[c];
    }
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
