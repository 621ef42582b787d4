// Phase-2 JPEG entropy merge: the per-block body shared by the CUDA kernel
// (merge.cu) and the serial host shim (host_shim.cpp).
//
// Block b's pre-aligned word c belongs at dense word (start_b >> 5) + c.
// Blocks tile the bit space without overlap, so every set bit of the dense
// stream comes from exactly one (block, word) pair and OR-ing the words in
// any order gives the same result. Indices at or past n_words are dropped,
// as the reference's scatter drops them.
#pragma once

#include <stddef.h>
#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

__host__ __device__ __forceinline__ void or_word(uint32_t* p, uint32_t v) {
#ifdef __CUDA_ARCH__
  atomicOr(p, v);
#else
  *p |= v;
#endif
}

// local: the block's n_aw words; start: its global start bit.
__host__ __device__ inline void merge_block(const int32_t* local, int32_t start,
                                            int n_aw, int n_words,
                                            uint32_t* dense) {
  const int w0 = start >> 5;
  for (int c = 0; c < n_aw; ++c) {
    const uint32_t v = (uint32_t)local[c];
    const int idx = w0 + c;
    // A zero word changes nothing; skipping it saves the atomic.
    if (v != 0u && idx >= 0 && idx < n_words) or_word(dense + idx, v);
  }
}
