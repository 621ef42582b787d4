// JPEG decode: crop, upsampling and YCbCr -> RGBA of one output pixel, and of
// an octet of eight neighbouring pixels of a row, shared by the CUDA kernel
// (ycc.cu) and the serial host shim (host_shim.cpp).
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

// RGBA of one pixel as a little-endian word r | g << 8 | b << 16 | 255 << 24:
// on the card the clips and the packing are two cvt.pack.sat instructions.
__host__ __device__ __forceinline__ uint32_t ycc_rgba_word(int y, int cb, int cr) {
  cb -= 128;
  cr -= 128;
  const int r = y + ((YCC_CR_R * cr + YCC_ONE_HALF) >> 16);
  const int g = y + ((YCC_CB_G * cb + YCC_ONE_HALF + YCC_CR_G * cr) >> 16);
  const int b = y + ((YCC_CB_B * cb + YCC_ONE_HALF) >> 16);
#ifdef __CUDA_ARCH__
  uint32_t hi, word;
  asm("cvt.pack.sat.u8.s32.b32 %0, %1, %2, %3;" : "=r"(hi) : "r"(255), "r"(b), "r"(0));
  asm("cvt.pack.sat.u8.s32.b32 %0, %1, %2, %3;" : "=r"(word) : "r"(g), "r"(r), "r"(hi));
  return word;
#else
  return ycc_clip(r) | (ycc_clip(g) << 8) | (ycc_clip(b) << 16) | 0xFF000000u;
#endif
}

// The output pixel at band row y, column x of the tile: one component is
// gray.
__host__ __device__ __forceinline__ uint32_t ycc_pixel(const YccComp* comps, int n_comp,
                                                       int y, int x) {
  const int yy = ycc_sample(comps[0], y, x);
  if (n_comp == 1) return (uint32_t)yy * 0x010101u | 0xFF000000u;
  return ycc_rgba_word(yy, ycc_sample(comps[1], y, x), ycc_sample(comps[2], y, x));
}

// ---- eight neighbouring pixels of a row ---------------------------------- //

// A tile of the batched kernel: one JPEG tile's part of the band. Rows of
// YCC_TILE_COLS int32 in the tile table; the geometry of component i starts
// at YCC_TILE_COMP + 8 * i.
#define YCC_TILE_COLS 32
#define YCC_TILE_NCOMP 0    // 1 (gray) or 3
#define YCC_TILE_X0 1       // the band's first column of the tile
#define YCC_TILE_W 2        // its columns
#define YCC_TILE_VARIANT 3  // how a whole octet is stored
#define YCC_TILE_COMP 8     // then per component:
#define YCC_COMP_PLANE 0    // first byte of its plane in the plane buffer
#define YCC_COMP_STRIDE 1   // then stride, h_exp, v_exp, r0, w0l, hw, comp_w
#define YCC_VARIANT_WORDS 0  // eight 4 B stores
#define YCC_VARIANT_VEC16 1  // two 16 B stores: the octets lie at 16 B boundaries
// A CTA covers YCC_CTA_OCTETS octets of YCC_CTA_ROWS rows of one tile; the
// grid is (CTAs down the band, CTAs across the widest tile, tiles).
#define YCC_CTA_OCTETS 32
#define YCC_CTA_ROWS 2
// The samplings the octet body is specialised for: with the expansion
// factors known when it is compiled, the other upsamplers drop out of it.
#define YCC_LAYOUT_ANY 0
#define YCC_LAYOUT_420 1  // three components, luma 1 x 1, chroma 2 x 2
#define YCC_LAYOUT_444 2  // three components, each 1 x 1

__host__ __device__ __forceinline__ YccComp ycc_tile_comp(const uint8_t* planes,
                                                          const int32_t* tile, int i) {
  const int32_t* g = tile + YCC_TILE_COMP + 8 * i;
  return YccComp{planes + (size_t)g[YCC_COMP_PLANE], g[1], g[2], g[3], g[4], g[5], g[6], g[7]};
}

// n (4 or 8) samples p[0..n-1], with one load where p lies at an n B
// boundary.
template <int n>
__host__ __device__ __forceinline__ void ycc_load(const uint8_t* p, int* s) {
#ifdef __CUDA_ARCH__
  if ((reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0) {
    uint32_t w[2];
    if (n == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x, w[1] = v.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    }
#pragma unroll
    for (int i = 0; i < n; ++i) s[i] = (int)((w[i >> 2] >> (8 * (i & 3))) & 255u);
    return;
  }
#endif
#pragma unroll
  for (int i = 0; i < n; ++i) s[i] = p[i];
}

// The six chroma samples of a row that an octet's fancy upsampling reads:
// columns c0 - 1 .. c0 + 4, the first and the last clamped into the window
// as ycc_sample clamps the neighbours (c0 .. c0 + 3 lie inside it for a
// whole octet), c0 a multiple of 4.
__host__ __device__ __forceinline__ void ycc_load6(const uint8_t* row, int c0, int last,
                                                   int v[6]) {
  v[0] = row[ycc_max(c0 - 1, 0)];
  ycc_load<4>(row + c0, v + 1);
  v[5] = row[ycc_min(c0 + 4, last)];
}

// The component's upsampled samples at band row y, columns x..x+7, x a
// multiple of 8 and x + 7 inside the tile: what ycc_sample gives at each,
// with the work the eight share done once. The fancy filters read six
// chroma columns (one 4 B load and two bytes a row, where a pixel at a time
// reads two to four bytes per pixel); for h2v2 their six column sums
// cs = 3 near + far are taken once.
__host__ __device__ __forceinline__ void ycc_sample8(const YccComp& c, int y, int x, int s[8]) {
  const int rr = c.r0 + y;
  const uint8_t* p = c.plane + (size_t)c.w0l * (size_t)c.stride;
  if (c.h_exp == 2 && c.comp_w > 2 && (c.v_exp == 1 || c.v_exp == 2)) {
    const int c0 = x >> 1, last = c.comp_w - 1;
    int v[6], shift = 2, even = 1, odd = 2;
    if (c.v_exp == 1) {
      ycc_load6(p + (size_t)rr * (size_t)c.stride, c0, last, v);
    } else {
      const int hr = rr >> 1;
      const int adj = (rr & 1) ? ycc_min(hr + 1, c.hw - 1) : ycc_max(hr - 1, 0);
      int far[6];
      ycc_load6(p + (size_t)hr * (size_t)c.stride, c0, last, v);
      ycc_load6(p + (size_t)adj * (size_t)c.stride, c0, last, far);
#pragma unroll
      for (int i = 0; i < 6; ++i) v[i] = 3 * v[i] + far[i];
      shift = 4, even = 8, odd = 7;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[2 * i] = (3 * v[i + 1] + v[i] + even) >> shift;
      s[2 * i + 1] = (3 * v[i + 1] + v[i + 2] + odd) >> shift;
    }
    return;
  }
  if (c.h_exp == 1) {
    const int row = c.v_exp == 1 ? rr : rr / c.v_exp;
    ycc_load<8>(p + (size_t)row * (size_t)c.stride + (size_t)x, s);
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = ycc_sample(c, y, x + i);
}

// The n (1..8) output pixels at band row y, columns x..x+n-1 of the tile, x a
// multiple of 8: a whole octet through ycc_sample8, the ragged right edge of
// a tile one pixel at a time through ycc_pixel.
__host__ __device__ __forceinline__ void ycc_octet(const YccComp* comps, int n_comp, int y,
                                                   int x, int n, uint32_t px[8]) {
  if (n < 8) {
    for (int i = 0; i < n; ++i) px[i] = ycc_pixel(comps, n_comp, y, x + i);
    return;
  }
  int yy[8];
  ycc_sample8(comps[0], y, x, yy);
  if (n_comp == 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) px[i] = (uint32_t)yy[i] * 0x010101u | 0xFF000000u;
    return;
  }
  int cb[8], cr[8];
  ycc_sample8(comps[1], y, x, cb);
  ycc_sample8(comps[2], y, x, cr);
#pragma unroll
  for (int i = 0; i < 8; ++i) px[i] = ycc_rgba_word(yy[i], cb[i], cr[i]);
}

// The tile's layout, one of YCC_LAYOUT_*.
__host__ __device__ __forceinline__ int ycc_layout(const YccComp* c, int n_comp) {
  if (n_comp != 3 || c[0].h_exp != 1 || c[0].v_exp != 1 || c[1].h_exp != c[2].h_exp ||
      c[1].v_exp != c[2].v_exp) {
    return YCC_LAYOUT_ANY;
  }
  if (c[1].h_exp == 2 && c[1].v_exp == 2) return YCC_LAYOUT_420;
  if (c[1].h_exp == 1 && c[1].v_exp == 1) return YCC_LAYOUT_444;
  return YCC_LAYOUT_ANY;
}

// ycc_octet for a tile of layout kLayout: the same body, compiled with that
// layout's expansion factors as constants.
template <int kLayout>
__host__ __device__ __forceinline__ void ycc_octet_as(const YccComp* comps, int n_comp, int y,
                                                      int x, int n, uint32_t px[8]) {
  if (kLayout == YCC_LAYOUT_ANY) {
    ycc_octet(comps, n_comp, y, x, n, px);
    return;
  }
  const int e = kLayout == YCC_LAYOUT_420 ? 2 : 1;
  YccComp c[3] = {comps[0], comps[1], comps[2]};
  c[0].h_exp = c[0].v_exp = 1;
  c[1].h_exp = c[1].v_exp = c[2].h_exp = c[2].v_exp = e;
  ycc_octet(c, 3, y, x, n, px);
}

// ycc_octet through the specialisation for the tile's layout.
__host__ __device__ __forceinline__ void ycc_octet_by_layout(const YccComp* comps, int n_comp,
                                                             int y, int x, int n,
                                                             uint32_t px[8]) {
  switch (ycc_layout(comps, n_comp)) {
    case YCC_LAYOUT_420:
      ycc_octet_as<YCC_LAYOUT_420>(comps, n_comp, y, x, n, px);
      break;
    case YCC_LAYOUT_444:
      ycc_octet_as<YCC_LAYOUT_444>(comps, n_comp, y, x, n, px);
      break;
    default:
      ycc_octet_as<YCC_LAYOUT_ANY>(comps, n_comp, y, x, n, px);
  }
}
