// JPEG entropy pack and merge: the per-pair arithmetic shared by the CUDA
// kernel (pack_merge.cu) and the serial host shim (host_shim.cpp).
//
// Same arithmetic as image_stitch_tpu/ops/pallas_kernels.py::_pack_kernel
// and jpeg_entropy_device.py::_pack_blocks_aligned: a block's (code, len)
// symbol slots are consumed in pairs V = code1 * 2^len2 | code2 (at most 56
// bits, carried as a (hi, lo) pair of 32-bit words) and ORed at a running
// bit offset that starts at (start & 31), into n_aw = local_words + 2 words
// pre-aligned to the block's global start bit. Word indices are clipped to
// [0, n_aw) exactly as the reference clips them, so an over-budget block
// produces the same words as the reference. Word c of the block then adds
// into dense word (start >> 5) + c; words at or past n_words are dropped.
#pragma once

#include <stddef.h>
#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

// Largest n_aw the bodies accept (local_words 24 + 2 = 26 is the largest the
// encoder uses); the wrapper checks it. The kernel gives each lane of a warp
// one staged word, so it must not exceed the warp size.
#define PACK_MAX_AW 32

// Shifts of a 32-bit word by 0..31 bits are defined in C++; the reference's
// XLA shifts yield 0 at 32 and beyond, and these helpers do the same.
__host__ __device__ __forceinline__ uint32_t shl32(uint32_t x, int s) {
  return (s < 0 || s >= 32) ? 0u : (x << s);
}

__host__ __device__ __forceinline__ uint32_t shr32(uint32_t x, int s) {
  return (s < 0 || s >= 32) ? 0u : (x >> s);
}

__host__ __device__ __forceinline__ int clamp_int(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// One pair's contribution: word idx[k] of the block's n_aw words gets val[k]
// ORed in.
struct PairWords {
  int idx[3];
  uint32_t val[3];
};

// The pair (c1, c2) with second length l2 whose last bit ends at bit `end`
// of the block's words (end = (start & 31) + the lengths of every slot up to
// and including this pair).
__host__ __device__ __forceinline__ PairWords pair_words(uint32_t c1,
                                                         uint32_t c2, int l2,
                                                         int end, int n_aw) {
  const uint32_t v_lo = shl32(c1, l2) | c2;
  const uint32_t v_hi = l2 == 0 ? 0u : shr32(c1, clamp_int(32 - l2, 0, 31));
  // Left shift that aligns V's lowest bit with the end of word w_e.
  const int sh = (32 - (end & 31)) & 31;
  const int inv = clamp_int(32 - sh, 0, 31);
  const uint32_t lo_spill = sh == 0 ? 0u : shr32(v_lo, inv);
  const uint32_t hi_spill = sh == 0 ? 0u : shr32(v_hi, inv);
  const int w_e = (end - 1) >> 5;  // -1 only for an empty first pair
  PairWords pw;
  pw.idx[0] = clamp_int(w_e, 0, n_aw - 1);
  pw.val[0] = shl32(v_lo, sh);
  pw.idx[1] = clamp_int(w_e - 1, 0, n_aw - 1);
  pw.val[1] = shl32(v_hi, sh) | lo_spill;
  pw.idx[2] = clamp_int(w_e - 2, 0, n_aw - 1);
  pw.val[2] = hi_spill;
  return pw;
}

// The dense index of the block's word c, or -1 when it falls outside
// [0, n_words).
__host__ __device__ __forceinline__ int dense_index(int32_t start, int c,
                                                    int n_words) {
  const int idx = (start >> 5) + c;
  return (idx >= 0 && idx < n_words) ? idx : -1;
}
