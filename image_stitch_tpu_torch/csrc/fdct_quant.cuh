// JPEG encode: integer YCbCr, level shift, islow forward DCT and
// quantization of one 8x8 block, shared by the CUDA kernel (fdct_quant.cu)
// and the serial host shim (host_shim.cpp).
//
// Same arithmetic as image_stitch_tpu_torch/ops/jpeg_dct.py (after
// image_stitch_tpu/ops/jpeg_dct.py), all int32:
// - Y = (19595 R + 38470 G + 7471 B + 2^15) >> 16 in 0..255; Cb and Cr add
//   128 << 16 and reach 256 on saturated input (pure blue gives Cb = 256),
//   unclamped;
// - 4:2:0 chroma: the 2x2 box of full-resolution Cb or Cr, (sum + 2) >> 2;
// - the row pass (final = false) then the column pass (final = true) of
//   jfdctint.c's butterfly, outputs scaled by 8;
// - round half away from zero: sign(c) * floor((|c| + 4q) / (8q)), an exact
//   integer division (fdct_quantize), which the kernel takes by reciprocal
//   (fdct_quantize_recip: a multiply-high and a one-sided correction).
//
// The kernel's split, which the shim repeats: a thread takes one row of 8
// pixels (fdct_row_444: colour once, then the row pass of all three
// components; 4:2:0: fdct_patch_420, two rows at once, with the chroma's
// 2x2 boxes, and fdct_pass over a row of boxes) and later one column of a
// block (fdct_column: the column pass and the quantizer). A thread never
// holds more than a row or a column.
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

#define FDCT_CONST_BITS 13
#define FDCT_PASS1_BITS 2

// Component `comp` (0 Y, 1 Cb, 2 Cr) of one pixel.
__host__ __device__ __forceinline__ int32_t fdct_ycc(int comp, int32_t r, int32_t g,
                                                     int32_t b) {
  const int32_t half = 1 << 15;
  if (comp == 0) return (19595 * r + 38470 * g + 7471 * b + half) >> 16;
  if (comp == 1) return (-11059 * r - 21709 * g + 32768 * b + half + (128 << 16)) >> 16;
  return (32768 * r - 27439 * g - 5329 * b + half + (128 << 16)) >> 16;
}

__host__ __device__ __forceinline__ int32_t fdct_descale(int32_t x, int n) {
  return (x + (1 << (n - 1))) >> n;
}

// One 8-point pass over d[0], d[stride], ..., d[7 * stride], in place.
__host__ __device__ __forceinline__ void fdct_pass(int32_t* d, int stride, bool final) {
  const int32_t d0 = d[0], d1 = d[stride], d2 = d[2 * stride], d3 = d[3 * stride];
  const int32_t d4 = d[4 * stride], d5 = d[5 * stride], d6 = d[6 * stride];
  const int32_t d7 = d[7 * stride];
  int32_t t0 = d0 + d7, t7 = d0 - d7;
  int32_t t1 = d1 + d6, t6 = d1 - d6;
  int32_t t2 = d2 + d5, t5 = d2 - d5;
  int32_t t3 = d3 + d4, t4 = d3 - d4;
  const int32_t t10 = t0 + t3, t13 = t0 - t3;
  const int32_t t11 = t1 + t2, t12 = t1 - t2;
  int shift;
  if (final) {
    d[0] = fdct_descale(t10 + t11, FDCT_PASS1_BITS);
    d[4 * stride] = fdct_descale(t10 - t11, FDCT_PASS1_BITS);
    shift = FDCT_CONST_BITS + FDCT_PASS1_BITS;
  } else {
    d[0] = (t10 + t11) * (1 << FDCT_PASS1_BITS);
    d[4 * stride] = (t10 - t11) * (1 << FDCT_PASS1_BITS);
    shift = FDCT_CONST_BITS - FDCT_PASS1_BITS;
  }
  int32_t z1 = (t12 + t13) * 4433;                  // FIX_0_541196100
  d[2 * stride] = fdct_descale(z1 + t13 * 6270, shift);   // FIX_0_765366865
  d[6 * stride] = fdct_descale(z1 - t12 * 15137, shift);  // FIX_1_847759065

  z1 = t4 + t7;
  int32_t z2 = t5 + t6;
  int32_t z3 = t4 + t6;
  int32_t z4 = t5 + t7;
  const int32_t z5 = (z3 + z4) * 9633;              // FIX_1_175875602
  t4 *= 2446;                                       // FIX_0_298631336
  t5 *= 16819;                                      // FIX_2_053119869
  t6 *= 25172;                                      // FIX_3_072711026
  t7 *= 12299;                                      // FIX_1_501321110
  z1 *= -7373;                                      // FIX_0_899976223
  z2 *= -20995;                                     // FIX_2_562915447
  z3 = z3 * -16069 + z5;                            // FIX_1_961570560
  z4 = z4 * -3196 + z5;                             // FIX_0_390180644
  d[7 * stride] = fdct_descale(t4 + z1 + z3, shift);
  d[5 * stride] = fdct_descale(t5 + z2 + z4, shift);
  d[3 * stride] = fdct_descale(t6 + z2 + z3, shift);
  d[stride] = fdct_descale(t7 + z1 + z4, shift);
}

// sign(c) * floor((|c| + 4q) / (8q)).
__host__ __device__ __forceinline__ int16_t fdct_quantize(int32_t c, int32_t q) {
  const uint32_t mag = (uint32_t)(c < 0 ? -c : c);
  const uint32_t quot = (mag + 4u * (uint32_t)q) / (8u * (uint32_t)q);
  return (int16_t)(c < 0 ? -(int32_t)quot : (int32_t)quot);
}

// floor(2^32 / (8q)) for a quantizer q >= 1: the reciprocal that
// fdct_quantize_recip multiplies by.
__host__ __device__ __forceinline__ uint32_t fdct_recip(int32_t q) {
  return (uint32_t)(0x100000000ull / (8ull * (uint32_t)q));
}

// fdct_quantize without the division. With n = |c| + 4q, d = 8q and m =
// fdct_recip(q) = 2^32 / d - e, 0 <= e < 1: n m / 2^32 = n / d - n e / 2^32
// lies in (n / d - 1, n / d] for every n below 2^32, so its floor is the
// quotient or one less, and one step up where the remainder still holds d
// fixes it. Exact for every coefficient and every q from 1 to 2^28.
__host__ __device__ __forceinline__ int16_t fdct_quantize_recip(int32_t c, int32_t q,
                                                                uint32_t m) {
  const uint32_t mag = (uint32_t)(c < 0 ? -c : c);
  const uint32_t d = 8u * (uint32_t)q;
  const uint32_t n = mag + 4u * (uint32_t)q;
#ifdef __CUDA_ARCH__
  uint32_t quot = __umulhi(n, m);
#else
  uint32_t quot = (uint32_t)(((uint64_t)n * m) >> 32);
#endif
  if (n - quot * d >= d) ++quot;
  return (int16_t)(c < 0 ? -(int32_t)quot : (int32_t)quot);
}

// One row of 8 pixels (r, g, b) of a 4:4:4 block: colour, level shift and
// the row pass of each component, into y, cb, cr.
__host__ __device__ __forceinline__ void fdct_row_444(const int32_t r[8], const int32_t g[8],
                                                      const int32_t b[8], int32_t y[8],
                                                      int32_t cb[8], int32_t cr[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    y[i] = fdct_ycc(0, r[i], g[i], b[i]) - 128;
    cb[i] = fdct_ycc(1, r[i], g[i], b[i]) - 128;
    cr[i] = fdct_ycc(2, r[i], g[i], b[i]) - 128;
  }
  fdct_pass(y, 1, false);
  fdct_pass(cb, 1, false);
  fdct_pass(cr, 1, false);
}

// Two rows of 8 pixels, one above the other, of a 4:2:0 MCU (px[0] the
// upper row's r, g, b, px[1] the lower's): each row's luma after the row
// pass into y[0], y[1]; the four 2x2 boxes' (sum + 2) >> 2 of Cb and Cr,
// level-shifted, before any pass, into cb and cr.
__host__ __device__ __forceinline__ void fdct_patch_420(const int32_t px[2][3][8],
                                                        int32_t y[2][8], int32_t cb[4],
                                                        int32_t cr[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) cb[k] = cr[k] = 2;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int32_t r = px[a][0][i], g = px[a][1][i], b = px[a][2][i];
      y[a][i] = fdct_ycc(0, r, g, b) - 128;
      cb[i >> 1] += fdct_ycc(1, r, g, b);
      cr[i >> 1] += fdct_ycc(2, r, g, b);
    }
    fdct_pass(y[a], 1, false);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    cb[k] = (cb[k] >> 2) - 128;
    cr[k] = (cr[k] >> 2) - 128;
  }
}

// Column c of a block after its row passes, in v: the column pass, then
// the quantizer with the table's column c (q and m = fdct_recip(q), both
// natural order); out gets coefficients c, 8 + c, ..., 56 + c at out[0],
// out[stride], ...
__host__ __device__ __forceinline__ void fdct_column(int32_t v[8], int c, const int32_t* q,
                                                     const uint32_t* m, int16_t* out,
                                                     int stride) {
  fdct_pass(v, 1, true);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    out[r * stride] = fdct_quantize_recip(v[r], q[r * 8 + c], m[r * 8 + c]);
  }
}

// Where block i of component `comp` starts in the band: 4:4:4 blocks are
// strip-major; 4:2:0 luma blocks go TL, TR, BL, BR within each 16x16 MCU,
// MCUs raster-major, and 4:2:0 chroma block i is MCU i.
__host__ __device__ __forceinline__ void fdct_block_origin(int i, int comp, int w,
                                                           bool s420, int* y0, int* x0) {
  if (!s420) {
    const int bpr = w / 8;
    *y0 = (i / bpr) * 8;
    *x0 = (i % bpr) * 8;
    return;
  }
  const int mpr = w / 16;
  const int m = comp == 0 ? i >> 2 : i;
  *y0 = (m / mpr) * 16;
  *x0 = (m % mpr) * 16;
  if (comp == 0) {
    *y0 += ((i >> 1) & 1) * 8;
    *x0 += (i & 1) * 8;
  }
}
