// Serial CPU build of the kernels' per-block bodies, for tests only.
//
// g++ compiles pack.cuh and merge.cuh here without CUDA, so the test suite
// can hold the kernels' own arithmetic against the plain torch versions on
// a machine without a GPU. The encoder never loads this library.
#include <stddef.h>
#include <stdint.h>

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
