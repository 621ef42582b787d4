// Positioned alpha compositing: the per-pixel "over", the tile culling and
// the per-run blend shared by the CUDA kernel (composite.cu) and the serial
// host shim (host_shim.cpp).
//
// Same arithmetic as image_stitch_tpu/ops/composite_device.py::
// _alpha_over_window_u8, the exact integer-rational "over":
//   copy when As = 255, keep when As = 0, otherwise
//   den   = 255 As + Ad (255 - As)
//   num   = s 255 As + d Ad (255 - As)        (per colour channel)
//   out   = (2 num + den) // (2 den)           (round half up)
//   new_a = (2 den + 255) // 510
// and an exact rational tie where (2 num) mod (2 den) == den, on which the
// host's float64 oracle may round the other way. num <= 255 den < 2^24.
// The caller replays a band with any tie on the host.
//
// One division per channel: with q = num / den and r = num mod den,
// 2 num = q (2 den) + 2 r and 0 <= 2 r < 2 den, so the rounded quotient is
// q + (2 r >= den) and the tie is 2 r == den. q comes from a 32-bit
// reciprocal of den, taken once per pixel, one high multiply per channel
// and one exact correction (composite_divmod): no integer division, and
// two int/float conversions per pixel.
//
// A segment's meta row is int64, so byte offsets into the packed sources
// take any size; coordinates inside the band are int32.
#pragma once

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

// Columns of a segment's meta row.
enum {
  META_Y0 = 0,     // first band row the segment covers
  META_X0 = 1,     // first band column
  META_H = 2,      // rows
  META_W = 3,      // columns
  META_OFFSET = 4, // byte offset of its first pixel in the packed sources
  META_STRIDE = 5, // bytes from one of its rows to the next
  META_COLS = 6
};

// A tile of the band: one thread block on the card.
#define COMPOSITE_TILE_H 16
#define COMPOSITE_TILE_W 128
// Consecutive pixels of one row that one thread owns.
#define COMPOSITE_RUN 8
// Segments culled per step into the block's shared list.
#define COMPOSITE_CHUNK 256

// m = 2^32 / den less 7 to 15, from a float estimate of 1 / den within a
// relative 2^-22: on the card the hardware reciprocal (one MUFU.RCP), on
// the host a float division. The two may differ by a unit or two; both
// stay inside the window that composite_divmod needs.
__host__ __device__ __forceinline__ uint32_t composite_recip(int den) {
#ifdef __CUDA_ARCH__
  float inv;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(inv) : "f"((float)den));
#else
  const float inv = 1.0f / (float)den;
#endif
  // inv * 2^32 is within 6 of 2^32 / den (its relative error and one float
  // ulp of a value below 2^25), so m is below 2^32 / den by 2 to 15.
  return (uint32_t)(inv * 4294967296.0f) - 8u;
}

// q = num / den and *r = num mod den for 0 <= num < 2^24, 255 <= den <
// 2^16, with m = composite_recip(den): num m / 2^32 lies in (num / den -
// 15 * 2^24 / 2^32, num / den), so its floor is q or q - 1, and one step up
// fixes it.
__host__ __device__ __forceinline__ int composite_divmod(int num, int den, uint32_t m, int* r) {
#ifdef __CUDA_ARCH__
  int q = (int)__umulhi((uint32_t)num, m);
#else
  int q = (int)(((uint64_t)(uint32_t)num * m) >> 32);
#endif
  int rem = num - q * den;
  if (rem >= den) {
    ++q;
    rem -= den;
  }
  *r = rem;
  return q;
}

// Alpha "over" of source pixel s onto d, RGBA packed R in the low byte.
// Adds 1 to *ties on an exact rational tie.
__host__ __device__ __forceinline__ uint32_t alpha_over_px(uint32_t s, uint32_t d, int* ties) {
  const int as = (int)(s >> 24);
  if (as == 255) return s;
  if (as == 0) return d;
  const int wd = (int)(d >> 24) * (255 - as);
  const int sa = 255 * as;
  const int den = sa + wd;  // >= 255
  const uint32_t m = composite_recip(den);
  uint32_t out = (uint32_t)((2 * den + 255) / 510) << 24;
  int tie = 0;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int num = (int)((s >> (8 * c)) & 0xFFu) * sa + (int)((d >> (8 * c)) & 0xFFu) * wd;
    int r;
    const int q = composite_divmod(num, den, m, &r);
    out |= (uint32_t)(q + (2 * r >= den)) << (8 * c);
    tie |= 2 * r == den;
  }
  *ties += tie;
  return out;
}

// A segment that touches a tile: where its pixels start, its row stride,
// and its rectangle in band coordinates.
struct CompositeHit {
  const uint8_t* base;
  int64_t stride;
  int y0, x0, h, w;
};

// Whether the segment of meta row m touches the tile of rows [ty0, ty0 +
// th) and columns [tx0, tx0 + tw); if so, fills *hit. Zero-area segments
// touch nothing.
__host__ __device__ __forceinline__ bool composite_cull(const int64_t* m, const uint8_t* srcs,
                                                        int ty0, int tx0, int th, int tw,
                                                        CompositeHit* hit) {
  const int y0 = (int)m[META_Y0];
  const int x0 = (int)m[META_X0];
  const int h = (int)m[META_H];
  const int w = (int)m[META_W];
  if (h <= 0 || w <= 0 || y0 >= ty0 + th || y0 + h <= ty0 || x0 >= tx0 + tw || x0 + w <= tx0) {
    return false;
  }
  hit->base = srcs + m[META_OFFSET];
  hit->stride = m[META_STRIDE];
  hit->y0 = y0;
  hit->x0 = x0;
  hit->h = h;
  hit->w = w;
  return true;
}

// Source pixel at p: one 4 B load where p is 4 B aligned.
__host__ __device__ __forceinline__ uint32_t composite_load_px(const uint8_t* p, bool aligned) {
#ifdef __CUDA_ARCH__
  if (aligned) return __ldg((const unsigned int*)p);
  return (uint32_t)__ldg(p) | ((uint32_t)__ldg(p + 1) << 8) | ((uint32_t)__ldg(p + 2) << 16) |
         ((uint32_t)__ldg(p + 3) << 24);
#else
  (void)aligned;
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
#endif
}

// Blends the hit's pixels over the run of COMPOSITE_RUN pixels d that
// starts at band pixel (y, x). Returns the run's ties. The run's source
// pixels are all loaded before the first blend, so their loads overlap.
__host__ __device__ __forceinline__ int composite_apply(const CompositeHit& hit, int y, int x,
                                                        uint32_t d[COMPOSITE_RUN]) {
  const int sy = y - hit.y0;
  const int lo = hit.x0 - x;  // the hit's columns in the run: [lo, hi)
  const int hi = lo + hit.w;
  if (sy < 0 || sy >= hit.h || hi <= 0 || lo >= COMPOSITE_RUN) return 0;
  const uint8_t* row = hit.base + (int64_t)sy * hit.stride;
  const bool aligned = (((uintptr_t)row) & 3u) == 0;
  uint32_t s[COMPOSITE_RUN];
#pragma unroll
  for (int i = 0; i < COMPOSITE_RUN; ++i) {
    s[i] = (i >= lo && i < hi) ? composite_load_px(row + (int64_t)(i - lo) * 4, aligned) : 0u;
  }
  int ties = 0;
#pragma unroll
  for (int i = 0; i < COMPOSITE_RUN; ++i) {
    if (i >= lo && i < hi) d[i] = alpha_over_px(s[i], d[i], &ties);
  }
  return ties;
}
