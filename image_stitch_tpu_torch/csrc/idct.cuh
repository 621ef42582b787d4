// JPEG decode: dezigzag, dequantize, islow IDCT and range limit of one 8x8
// block, shared by the CUDA kernel (idct.cu) and the serial host shim
// (host_shim.cpp).
//
// Same arithmetic as codecs/jpeg/libjpeg_exact.py (jidctint.c's
// jpeg_idct_islow and jdmaster.c's range limit), in int64, so exact for
// every int16 coefficient times every 16-bit quantizer: the column pass
// descales by CONST_BITS - PASS1_BITS, the row pass by CONST_BITS +
// PASS1_BITS + 3. libjpeg's shortcut for a column whose AC terms are zero
// gives dc << PASS1_BITS, which the general pass gives too (the rounding
// bit never carries into dc << 13), so there is no shortcut here.
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

#define IDCT_CONST_BITS 13
#define IDCT_PASS1_BITS 2

// The natural (row-major) index of each zigzag position j, as
// codecs/jpeg/tables.py's ZIGZAG, and the zigzag position of each natural
// index, its inverse.
#define JPEG_ZIGZAG_ORDER                                                   \
  {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,           \
   12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,          \
   35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,          \
   58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63}
#define JPEG_NATURAL_TO_ZIGZAG                                              \
  {0,  1,  5,  6,  14, 15, 27, 28, 2,  4,  7,  13, 16, 26, 29, 42,          \
   3,  8,  12, 17, 25, 30, 41, 43, 9,  11, 18, 24, 31, 40, 44, 53,          \
   10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,          \
   21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63}

// One 8-point pass of jidctint.c's butterfly over v[0..7], in place; the
// outputs are descaled by n bits (round half up, arithmetic shift).
__host__ __device__ __forceinline__ void idct_islow_pass(int64_t v[8], int n) {
  const int64_t one = (int64_t)1 << IDCT_CONST_BITS;
  int64_t z2 = v[2], z3 = v[6];
  int64_t z1 = (z2 + z3) * 4433;                    // FIX_0_541196100
  const int64_t tmp2 = z1 + z3 * -15137;            // FIX_1_847759065
  const int64_t tmp3 = z1 + z2 * 6270;              // FIX_0_765366865
  const int64_t tmp0 = (v[0] + v[4]) * one;
  const int64_t tmp1 = (v[0] - v[4]) * one;
  const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

  int64_t t0 = v[7], t1 = v[5], t2 = v[3], t3 = v[1];
  z1 = t0 + t3;
  z2 = t1 + t2;
  z3 = t0 + t2;
  int64_t z4 = t1 + t3;
  const int64_t z5 = (z3 + z4) * 9633;              // FIX_1_175875602
  t0 *= 2446;                                       // FIX_0_298631336
  t1 *= 16819;                                      // FIX_2_053119869
  t2 *= 25172;                                      // FIX_3_072711026
  t3 *= 12299;                                      // FIX_1_501321110
  z1 *= -7373;                                      // FIX_0_899976223
  z2 *= -20995;                                     // FIX_2_562915447
  z3 = z3 * -16069 + z5;                            // FIX_1_961570560
  z4 = z4 * -3196 + z5;                             // FIX_0_390180644
  t0 += z1 + z3;
  t1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1 + z4;

  const int64_t round = (int64_t)1 << (n - 1);
  v[0] = (tmp10 + t3 + round) >> n;
  v[7] = (tmp10 - t3 + round) >> n;
  v[1] = (tmp11 + t2 + round) >> n;
  v[6] = (tmp11 - t2 + round) >> n;
  v[2] = (tmp12 + t1 + round) >> n;
  v[5] = (tmp12 - t1 + round) >> n;
  v[3] = (tmp13 + t0 + round) >> n;
  v[4] = (tmp13 - t0 + round) >> n;
}

// jdmaster.c's post-IDCT table POST[x & 1023] in closed form: a wrap, not a
// clamp (x & 1023 below 128 -> +128; below 512 -> 255; below 896 -> 0; else
// -896).
__host__ __device__ __forceinline__ uint8_t idct_range_limit(int64_t x) {
  const int j = (int)(x & 1023);
  return (uint8_t)(j < 128 ? j + 128 : (j < 512 ? 255 : (j < 896 ? 0 : j - 896)));
}

// Column c of a block: its 8 coefficients in natural order, taken from the
// block's k zigzag-prefix coefficients `zz` (zero past k), dequantized by
// the natural-order table `q`, through the column pass into ws[0..7].
__host__ __device__ __forceinline__ void idct_column(const int16_t* zz, int k,
                                                     const int32_t* q,
                                                     const uint8_t* nat_to_zz, int c,
                                                     int64_t ws[8]) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int nat = r * 8 + c;
    const int z = nat_to_zz[nat];
    ws[r] = z < k ? (int64_t)zz[z] * (int64_t)q[nat] : 0;
  }
  idct_islow_pass(ws, IDCT_CONST_BITS - IDCT_PASS1_BITS);
}

// Row r of the column pass's workspace, v[c] = ws[c][r], through the row
// pass and the range limit into 8 samples.
__host__ __device__ __forceinline__ void idct_row(int64_t v[8], uint8_t out[8]) {
  idct_islow_pass(v, IDCT_CONST_BITS + IDCT_PASS1_BITS + 3);
#pragma unroll
  for (int c = 0; c < 8; ++c) out[c] = idct_range_limit(v[c]);
}
