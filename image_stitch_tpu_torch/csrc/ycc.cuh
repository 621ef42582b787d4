// JPEG decode: crop, upsampling and YCbCr -> RGBA of one output pixel, shared
// by the CUDA kernel (ycc.cu) and the serial host shim (host_shim.cpp).
//
// Same arithmetic as image_stitch_tpu_torch/ops/jpeg_idct_device.py
// (window_to_rgba, after codecs/jpeg/libjpeg_exact.py):
// - a component's window is rows [w0l, w0l + hw) and columns [0, comp_w) of
//   its IDCT plane; the band's row y is the window's upsampled row r0 + y;
// - h2v1 fancy (h_exp 2, v_exp 1, comp_w > 2): (3 p + near + 1 or 2) >> 2;
// - h2v2 fancy (h_exp 2, v_exp 2, comp_w > 2): column sums cs = 3 p + the
//   row above (even output rows) or below (odd ones), then
//   (3 cs + near cs + 8 or 7) >> 4;
// - anything else, integer upsampling: sample (R / v_exp, x / h_exp).
// The neighbours are clamped into the window. At the first and last columns
// that gives jdsample.c's edge rules: (4 p + 1) >> 2 = p and (4 p + 2) >> 2 = p
// for h2v1, (4 cs + 8) >> 4 and (4 cs + 7) >> 4 for h2v2. The window has an
// extra row on each side that is not an image edge, so clamping rows acts
// only at true image edges.
// - colour: jdcolor.c's SCALEBITS 16 fixed point; every product is below
//   116130 * 128 < 2^24, so int32 holds it; clipped to 0..255; alpha 255.
//   One component is gray: R = G = B = Y.
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

#define YCC_CR_R 91881    // FIX(1.40200)
#define YCC_CB_B 116130   // FIX(1.77200)
#define YCC_CB_G (-22554) // -FIX(0.34414)
#define YCC_CR_G (-46802) // -FIX(0.71414)
#define YCC_ONE_HALF (1 << 15)

// One component's window: its plane (the IDCT's output for the band's
// block rows), the plane's row stride in bytes, and the geometry.
struct YccComp {
  const uint8_t* plane;
  int stride;
  int h_exp;
  int v_exp;
  int r0;
  int w0l;
  int hw;
  int comp_w;
};

__host__ __device__ __forceinline__ int ycc_min(int a, int b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int ycc_max(int a, int b) { return a > b ? a : b; }

// The component's upsampled sample at band row y, column x.
__host__ __device__ __forceinline__ int ycc_sample(const YccComp& c, int y, int x) {
  const int rr = c.r0 + y;
  const uint8_t* p = c.plane + (size_t)c.w0l * (size_t)c.stride;
  if (c.h_exp == 2 && c.comp_w > 2 && (c.v_exp == 1 || c.v_exp == 2)) {
    const int xx = x >> 1;
    const int odd = x & 1;
    const int xn = odd ? ycc_min(xx + 1, c.comp_w - 1) : ycc_max(xx - 1, 0);
    if (c.v_exp == 1) {
      const uint8_t* row = p + (size_t)rr * (size_t)c.stride;
      return (3 * row[xx] + row[xn] + 1 + odd) >> 2;
    }
    const int hr = rr >> 1;
    const int adj = (rr & 1) ? ycc_min(hr + 1, c.hw - 1) : ycc_max(hr - 1, 0);
    const uint8_t* near_row = p + (size_t)hr * (size_t)c.stride;
    const uint8_t* far_row = p + (size_t)adj * (size_t)c.stride;
    const int cs = 3 * near_row[xx] + far_row[xx];
    const int cs_n = 3 * near_row[xn] + far_row[xn];
    return (3 * cs + cs_n + 8 - odd) >> 4;
  }
  return p[(size_t)(rr / c.v_exp) * (size_t)c.stride + (size_t)(x / c.h_exp)];
}

__host__ __device__ __forceinline__ uint32_t ycc_clip(int v) {
  return (uint32_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// RGBA of one pixel as a little-endian word r | g << 8 | b << 16 | 255 << 24.
__host__ __device__ __forceinline__ uint32_t ycc_rgba_word(int y, int cb, int cr) {
  cb -= 128;
  cr -= 128;
  const uint32_t r = ycc_clip(y + ((YCC_CR_R * cr + YCC_ONE_HALF) >> 16));
  const uint32_t g = ycc_clip(y + ((YCC_CB_G * cb + YCC_ONE_HALF + YCC_CR_G * cr) >> 16));
  const uint32_t b = ycc_clip(y + ((YCC_CB_B * cb + YCC_ONE_HALF) >> 16));
  return r | (g << 8) | (b << 16) | 0xFF000000u;
}

// The output pixel at band row y, column x of the tile: one component is
// gray.
__host__ __device__ __forceinline__ uint32_t ycc_pixel(const YccComp* comps, int n_comp,
                                                       int y, int x) {
  const int yy = ycc_sample(comps[0], y, x);
  if (n_comp == 1) return (uint32_t)yy * 0x010101u | 0xFF000000u;
  return ycc_rgba_word(yy, ycc_sample(comps[1], y, x), ycc_sample(comps[2], y, x));
}
