// Positioned alpha compositing: the per-pixel body shared by the CUDA kernel
// (composite.cu) and the serial host shim (host_shim.cpp).
//
// Same arithmetic as image_stitch_tpu/ops/composite_device.py::
// _alpha_over_window_u8, the exact integer-rational "over":
//   copy when As = 255, keep when As = 0, otherwise
//   den   = 255 As + Ad (255 - As)
//   num   = s 255 As + d Ad (255 - As)        (per colour channel)
//   out   = (2 num + den) // (2 den)           (round half up)
//   new_a = (2 den + 255) // 510
// and an exact rational tie where (2 num) mod (2 den) == den, on which the
// host's float64 oracle may round the other way. Every term fits in int32
// (num < 2^25). The caller replays a band with any tie on the host.
//
// A segment's meta row is int64, so byte offsets into the packed sources
// take any size.
#pragma once

#include <stddef.h>
#include <stdint.h>

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

// Alpha "over" of source pixel s onto d, in place. Returns 1 on an exact
// rational tie, else 0.
__host__ __device__ __forceinline__ int alpha_over_u8(const uint8_t* s, uint8_t* d) {
  const int as = s[3];
  if (as == 255) {
    d[0] = s[0];
    d[1] = s[1];
    d[2] = s[2];
    d[3] = s[3];
    return 0;
  }
  if (as == 0) return 0;
  const int wd = d[3] * (255 - as);
  const int den = 255 * as + wd;  // >= 255
  int tie = 0;
  for (int c = 0; c < 3; ++c) {
    const int num = s[c] * (255 * as) + d[c] * wd;
    tie |= (2 * num) % (2 * den) == den;
    d[c] = (uint8_t)((2 * num + den) / (2 * den));
  }
  d[3] = (uint8_t)((2 * den + 255) / 510);
  return tie;
}

// Band pixel (y, x): the background bg, then every segment that covers it,
// in z order (back to front). Alpha-over is independent for each pixel, so
// this loop over segments gives what the reference's scan of per-segment
// window updates gives. Writes the pixel to out and returns its tie count.
__host__ __device__ inline int composite_pixel(int y, int x, const int64_t* metas, int s_count,
                                               const uint8_t* srcs, const uint8_t bg[4],
                                               uint8_t out[4]) {
  uint8_t d[4] = {bg[0], bg[1], bg[2], bg[3]};
  int ties = 0;
  for (int s = 0; s < s_count; ++s) {
    const int64_t* m = metas + (size_t)s * META_COLS;
    const int64_t sy = y - m[META_Y0];
    const int64_t sx = x - m[META_X0];
    if (sy < 0 || sy >= m[META_H] || sx < 0 || sx >= m[META_W]) continue;
    ties += alpha_over_u8(srcs + (size_t)m[META_OFFSET] + (size_t)sy * (size_t)m[META_STRIDE] +
                              (size_t)sx * 4,
                          d);
  }
  out[0] = d[0];
  out[1] = d[1];
  out[2] = d[2];
  out[3] = d[3];
  return ties;
}
