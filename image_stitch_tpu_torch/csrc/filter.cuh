// PNG filter select: the per-byte and per-row bodies shared by the CUDA
// kernel (filter.cu) and the serial host shim (host_shim.cpp).
//
// Same semantics as image_stitch_tpu/ops/pallas_kernels.py::_filter_kernel
// and ops/device.py::filter_select_trace (png-filter.ts:148-183): for each
// row the five candidates None, Sub, Up, Average and Paeth, with `up` the
// row above (the carry row for row 0) and `left`/`upleft` bpp bytes back
// (0 for the first bpp bytes of a row); each candidate scored as the sum of
// |signed byte|; the first minimum wins under a strict `<`.
//
// Rows are read in PNG byte order. A band of 16-bit samples lies in memory
// little-endian, and PNG wants each sample big-endian: with swap = 1 byte i
// of a row is memory byte i ^ 1, so the band's big-endian byte view is
// never built.
#pragma once

#include <stddef.h>
#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

#define FILTER_COUNT 5

__host__ __device__ __forceinline__ int filter_abs(int v) { return v < 0 ? -v : v; }

// The Paeth predictor (png-filter.ts:16-26).
__host__ __device__ __forceinline__ int filter_paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = filter_abs(p - a);
  const int pb = filter_abs(p - b);
  const int pc = filter_abs(p - c);
  return (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
}

// Residue of filter k for raw byte x with left a, up b and upleft c.
__host__ __device__ __forceinline__ int filter_residue(int k, int x, int a, int b, int c) {
  switch (k) {
    case 0: return x;
    case 1: return (x - a) & 0xFF;
    case 2: return (x - b) & 0xFF;
    case 3: return (x - ((a + b) >> 1)) & 0xFF;
    default: return (x - filter_paeth(a, b, c)) & 0xFF;
  }
}

// |v| of a residue read as a signed byte.
__host__ __device__ __forceinline__ int filter_score(int v) { return v > 127 ? 256 - v : v; }

// The neighbourhood of byte i: raw x, left a, up b, upleft c.
struct FilterPixel {
  int x, a, b, c;
};

__host__ __device__ __forceinline__ FilterPixel filter_pixel(const uint8_t* raw, int raw_swap,
                                                             const uint8_t* up, int up_swap,
                                                             int i, int bpp) {
  FilterPixel p;
  p.x = raw[i ^ raw_swap];
  p.b = up[i ^ up_swap];
  p.a = 0;
  p.c = 0;
  if (i >= bpp) {
    p.a = raw[(i - bpp) ^ raw_swap];
    p.c = up[(i - bpp) ^ up_swap];
  }
  return p;
}

// Adds byte i's five scores to sums.
__host__ __device__ __forceinline__ void filter_accumulate(const FilterPixel& p, int sums[FILTER_COUNT]) {
  for (int k = 0; k < FILTER_COUNT; ++k) sums[k] += filter_score(filter_residue(k, p.x, p.a, p.b, p.c));
}

// The first minimum of the five sums: a strict `<` keeps the earlier
// filter on a tie.
__host__ __device__ __forceinline__ int filter_choose(const int sums[FILTER_COUNT]) {
  int best = sums[0];
  int choice = 0;
  for (int k = 1; k < FILTER_COUNT; ++k) {
    if (sums[k] < best) {
      best = sums[k];
      choice = k;
    }
  }
  return choice;
}

// One row of n bytes, serially: scores, choice, then the winner's bytes
// into out. Returns the filter type.
__host__ __device__ inline int filter_row_serial(const uint8_t* raw, int raw_swap, const uint8_t* up,
                                                 int up_swap, int n, int bpp, uint8_t* out) {
  int sums[FILTER_COUNT] = {0, 0, 0, 0, 0};
  for (int i = 0; i < n; ++i) filter_accumulate(filter_pixel(raw, raw_swap, up, up_swap, i, bpp), sums);
  const int choice = filter_choose(sums);
  for (int i = 0; i < n; ++i) {
    const FilterPixel p = filter_pixel(raw, raw_swap, up, up_swap, i, bpp);
    out[i] = (uint8_t)filter_residue(choice, p.x, p.a, p.b, p.c);
  }
  return choice;
}
