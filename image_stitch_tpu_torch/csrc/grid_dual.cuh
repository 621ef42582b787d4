// The fused uniform-grid step: the addressing of the tile stack, the split
// of a band over CTAs, and the per-word helpers, shared by the
// CUDA kernel (grid_dual.cu) and the serial host shim (host_shim.cpp).
//
// A tile stack is (gy, gx, th, tw, 4) uint8, contiguous: canvas pixel (r, x)
// is tiles[r / th, x / tw, r % th, x % tw], 4 bytes, and canvas row -1 is the
// carry row `prev` ((gx * tw * 4,) uint8). The per-pixel arithmetic is the
// filter's (filter.cuh: filter_word_scores, filter_word_residue,
// filter_choose) and the quantizer's (fdct_quant.cuh: fdct_row_444,
// fdct_column); this header adds only where the bytes are.
#pragma once

#include <stddef.h>
#include <stdint.h>

#include "fdct_quant.cuh"
#include "filter.cuh"

#define GRID_DUAL_ROWS 8             // canvas rows of a strip: one JPEG block row
#define GRID_DUAL_THREADS 512        // threads of a CTA: 16 warps
#define GRID_DUAL_SUB_PX 512         // pixels of a window are a multiple of this: 32 a warp
#define GRID_DUAL_STEP_PX 32         // pixels a warp takes a step: 4 blocks
#define GRID_DUAL_WIN_PX 1024        // pixels of a window held in shared memory
#define GRID_DUAL_MAX_CTAS 8         // CTAs across a strip
#define GRID_DUAL_MIN_CHUNK_PX 128   // fewest pixels a CTA takes where the width allows
#define GRID_DUAL_PAD 4              // words before a raw row's pixel 0: its left word at 3

// How a band of w pixels a row is split: `ctas` CTAs across
// each strip, CTA k taking pixels [k * chunk_px, min(w, (k + 1) * chunk_px)),
// chunk_px a multiple of 8; each CTA walks its chunk in `windows` windows of
// win_px pixels (a multiple of GRID_DUAL_SUB_PX, at most GRID_DUAL_WIN_PX).
struct GridDualSplit {
  int ctas;
  int chunk_px;
  int win_px;
  int windows;
};

__host__ __device__ inline GridDualSplit grid_dual_split(int w) {
  GridDualSplit s;
  const int groups = (w + 7) / 8;  // 8-pixel groups
  const int min_groups = GRID_DUAL_MIN_CHUNK_PX / 8;
  int k = (groups + min_groups - 1) / min_groups;
  k = k < 1 ? 1 : (k > GRID_DUAL_MAX_CTAS ? GRID_DUAL_MAX_CTAS : k);
  s.chunk_px = ((groups + k - 1) / k) * 8;
  s.ctas = (w + s.chunk_px - 1) / s.chunk_px;  // every CTA gets a pixel
  if (s.ctas < 1) s.ctas = 1;
  const int sub = ((s.chunk_px + GRID_DUAL_SUB_PX - 1) / GRID_DUAL_SUB_PX) * GRID_DUAL_SUB_PX;
  s.win_px = sub < GRID_DUAL_WIN_PX ? sub : GRID_DUAL_WIN_PX;
  s.windows = (s.chunk_px + s.win_px - 1) / s.win_px;
  return s;
}

// CTAs of a launch over `rows` canvas rows of w pixels.
__host__ __device__ inline int grid_dual_ctas(int rows, int w) {
  return ((rows + GRID_DUAL_ROWS - 1) / GRID_DUAL_ROWS) * grid_dual_split(w).ctas;
}

// Each of a CTA's 16 warps takes a slice of win_px / 16 pixels of the window
// (a multiple of GRID_DUAL_STEP_PX). Words of a warp's raw row in shared
// memory: its slice's pixels after GRID_DUAL_PAD words, so that the stride
// is 4 mod 32 and the 8 rows of a block fall in distinct banks.
__host__ __device__ __forceinline__ int grid_dual_slice_px(int win_px) {
  return win_px / (GRID_DUAL_THREADS / 32);
}

__host__ __device__ __forceinline__ int grid_dual_stride(int win_px) {
  return grid_dual_slice_px(win_px) + GRID_DUAL_PAD;
}

// Byte offset of canvas pixel (r, 0) in the tile stack.
__host__ __device__ __forceinline__ size_t grid_row_offset(int r, int gx, int th, int tw) {
  const int ty = r / th;
  return ((size_t)ty * (size_t)gx * (size_t)th + (size_t)(r - ty * th)) * (size_t)tw * 4u;
}

// Byte offset of canvas pixel (0, x) from pixel (0, 0): tile column x / tw
// is th * tw pixels on.
__host__ __device__ __forceinline__ size_t grid_col_offset(int x, int th, int tw) {
  const int tx = x / tw;
  return ((size_t)tx * (size_t)th * (size_t)tw + (size_t)(x - tx * tw)) * 4u;
}

// Where canvas pixel (r, x) lies: the tile stack, or the carry row for r = -1.
__host__ __device__ __forceinline__ const uint8_t* grid_pixel(const uint8_t* tiles,
                                                             const uint8_t* prev, int r, int x,
                                                             int gx, int th, int tw) {
  if (r < 0) return prev + (size_t)x * 4u;
  return tiles + grid_row_offset(r, gx, th, tw) + grid_col_offset(x, th, tw);
}

// R, G and B of 8 RGBA words.
__host__ __device__ __forceinline__ void grid_rgb8(const uint32_t px[8], int32_t r[8],
                                                   int32_t g[8], int32_t b[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    r[i] = (int32_t)(px[i] & 0xffu);
    g[i] = (int32_t)((px[i] >> 8) & 0xffu);
    b[i] = (int32_t)((px[i] >> 16) & 0xffu);
  }
}

// The scratch buffer of the exchange between a strip's CTAs, in uint32
// words: a 64-bit ticket counter, then a flag per CTA, then each CTA's
// sums, GRID_DUAL_ROWS * FILTER_COUNT words.
#define GRID_DUAL_SUMS (GRID_DUAL_ROWS * FILTER_COUNT)

__host__ __device__ __forceinline__ size_t grid_dual_scratch_words(int cap) {
  return 2 + (size_t)cap * (1 + GRID_DUAL_SUMS);
}

// Sums of every CTA of a strip, in rank order, and the row's filter: the
// first minimum under a strict `<`, as filter.cu chooses.
__host__ __device__ __forceinline__ int grid_dual_choose(const uint32_t* const* partials,
                                                         int ranks, int row) {
  int total[FILTER_COUNT];
  for (int k = 0; k < FILTER_COUNT; ++k) {
    uint32_t t = 0u;
    for (int q = 0; q < ranks; ++q) t += partials[q][row * FILTER_COUNT + k];
    total[k] = (int)t;  // below 128 * n < 2^31
  }
  return filter_choose(total);
}
