// Phase-1 JPEG entropy pack: the per-block body shared by the CUDA kernel
// (pack.cu) and the serial host shim (host_shim.cpp).
//
// Same arithmetic as image_stitch_tpu/ops/pallas_kernels.py::_pack_kernel
// and jpeg_entropy_device.py::_pack_blocks_aligned: a block's (code, len)
// symbol slots are consumed in pairs V = code1 * 2^len2 | code2 (at most 56
// bits, carried as a (hi, lo) pair of 32-bit words) and ORed at a running
// bit offset that starts at (start & 31), into n_aw = local_words + 2 words
// pre-aligned to the block's global start bit. Word indices are clipped to
// [0, n_aw) exactly as the reference clips them, so an over-budget block
// produces the same (discarded) words as the reference.
#pragma once

#include <stddef.h>
#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

// Largest n_aw the body accepts (local_words 24 + 2 = 26 is the largest the
// encoder uses); the wrappers check it.
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

// codes/lens: the block's n_sym slots (codes hold uint32 bit patterns);
// start: the block's global start bit; out: n_aw words.
__host__ __device__ inline void pack_block(const int32_t* codes,
                                           const int32_t* lens, int32_t start,
                                           int n_sym, int n_aw, int32_t* out) {
  uint32_t acc[PACK_MAX_AW];
  for (int i = 0; i < n_aw; ++i) acc[i] = 0u;
  int off = start & 31;
  for (int s = 0; s < n_sym; s += 2) {
    const uint32_t c1 = (uint32_t)codes[s];
    const int l1 = lens[s];
    // An odd slot count pads with one zero-length slot, as the reference.
    const bool has2 = s + 1 < n_sym;
    const uint32_t c2 = has2 ? (uint32_t)codes[s + 1] : 0u;
    const int l2 = has2 ? lens[s + 1] : 0;
    const uint32_t v_lo = shl32(c1, l2) | c2;
    const uint32_t v_hi = l2 == 0 ? 0u : shr32(c1, clamp_int(32 - l2, 0, 31));
    const int end = off + l1 + l2;
    // Left shift that aligns V's lowest bit with the end of word w_e.
    const int sh = (32 - (end & 31)) & 31;
    const int inv = clamp_int(32 - sh, 0, 31);
    const uint32_t lo_spill = sh == 0 ? 0u : shr32(v_lo, inv);
    const uint32_t hi_spill = sh == 0 ? 0u : shr32(v_hi, inv);
    const int w_e = (end - 1) >> 5;  // -1 only for an empty first pair
    acc[clamp_int(w_e, 0, n_aw - 1)] |= shl32(v_lo, sh);
    acc[clamp_int(w_e - 1, 0, n_aw - 1)] |= shl32(v_hi, sh) | lo_spill;
    acc[clamp_int(w_e - 2, 0, n_aw - 1)] |= hi_spill;
    off = end;
  }
  for (int i = 0; i < n_aw; ++i) out[i] = (int32_t)acc[i];
}
