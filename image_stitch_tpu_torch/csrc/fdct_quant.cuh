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
//   integer division (no -use_fast_math, which would not touch it anyway).
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

// s: 64 samples of one component, row-major, before the level shift;
// q: the natural-order table; out: 64 int16 quantized natural-order
// coefficients. s is overwritten.
__host__ __device__ __forceinline__ void fdct_quant_block(int32_t s[64], const int32_t* q,
                                                          int16_t* out) {
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] -= 128;
#pragma unroll
  for (int r = 0; r < 8; ++r) fdct_pass(s + 8 * r, 1, false);
#pragma unroll
  for (int c = 0; c < 8; ++c) fdct_pass(s + c, 8, true);
#pragma unroll
  for (int i = 0; i < 64; ++i) out[i] = fdct_quantize(s[i], q[i]);
}

// The 64 samples of component `comp` of the 8x8 block whose top-left pixel
// is (y0, x0) of a band of `w` pixels, `ch` bytes per pixel (R, G, B first);
// with `sub` (4:2:0 chroma) each sample is the (sum + 2) >> 2 of the 2x2
// pixels at (y0 + 2r, x0 + 2c).
__host__ __device__ __forceinline__ void fdct_gather(const uint8_t* band, int w, int ch,
                                                     int comp, int y0, int x0, bool sub,
                                                     int32_t s[64]) {
  for (int r = 0; r < 8; ++r) {
    for (int c = 0; c < 8; ++c) {
      int32_t v;
      if (sub) {
        v = 2;
        for (int a = 0; a < 2; ++a) {
          for (int bb = 0; bb < 2; ++bb) {
            const uint8_t* px =
                band + ((size_t)(y0 + 2 * r + a) * (size_t)w + (size_t)(x0 + 2 * c + bb)) * ch;
            v += fdct_ycc(comp, px[0], px[1], px[2]);
          }
        }
        v >>= 2;
      } else {
        const uint8_t* px = band + ((size_t)(y0 + r) * (size_t)w + (size_t)(x0 + c)) * ch;
        v = fdct_ycc(comp, px[0], px[1], px[2]);
      }
      s[r * 8 + c] = v;
    }
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
