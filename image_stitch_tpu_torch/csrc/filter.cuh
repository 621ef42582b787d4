// PNG filter select: the per-byte, per-word and per-row bodies shared by the
// CUDA kernels (filter.cu) and the serial host shim (host_shim.cpp).
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
//
// Two forms of the same arithmetic:
// - per byte (filter_pixel, filter_residue): any bpp and any row length;
// - per 32-bit word of four byte lanes (filter_word_*): bpp 4 or 8 and rows
//   of a whole number of words, where `left` of lane k in word j is lane k
//   of word j - bpp / 4. On the card the lane operations are the SIMD video
//   intrinsics (__vsub4, __vhaddu4, __vabsdiffu4, ...) and a lane score sum
//   is one vabsdiff4 with accumulate; on the host they are byte loops with
//   the same results.
#pragma once

#include <stddef.h>
#include <stdint.h>
#include <string.h>

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

// ------------------------------------------------------------------------ //
// Word form: four byte lanes of a little-endian uint32, lane k = byte 4j + k.
// ------------------------------------------------------------------------ //

#ifndef __CUDA_ARCH__
// Lane k of a, b through f, each result masked to a byte.
template <class F>
inline uint32_t filter_lanes(uint32_t a, uint32_t b, F f) {
  uint32_t r = 0;
  for (int k = 0; k < 4; ++k) {
    const int x = (int)((a >> (8 * k)) & 0xFFu);
    const int y = (int)((b >> (8 * k)) & 0xFFu);
    r |= ((uint32_t)f(x, y) & 0xFFu) << (8 * k);
  }
  return r;
}
#endif

// (a - b) mod 256 per lane.
__host__ __device__ __forceinline__ uint32_t filter_sub4(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  return __vsub4(a, b);
#else
  return filter_lanes(a, b, [](int x, int y) { return x - y; });
#endif
}

// floor((a + b) / 2) per lane.
__host__ __device__ __forceinline__ uint32_t filter_avg4(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  return __vhaddu4(a, b);
#else
  return filter_lanes(a, b, [](int x, int y) { return (x + y) >> 1; });
#endif
}

// |a - b| per lane.
__host__ __device__ __forceinline__ uint32_t filter_absdiff4(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  return __vabsdiffu4(a, b);
#else
  return filter_lanes(a, b, [](int x, int y) { return x > y ? x - y : y - x; });
#endif
}

// 0xFF where a >= b, else 0, per lane.
__host__ __device__ __forceinline__ uint32_t filter_ge4(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  return __vcmpgeu4(a, b);
#else
  return filter_lanes(a, b, [](int x, int y) { return x >= y ? 0xFF : 0; });
#endif
}

// 0xFF where a <= b, else 0, per lane.
__host__ __device__ __forceinline__ uint32_t filter_le4(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  return __vcmpleu4(a, b);
#else
  return filter_lanes(a, b, [](int x, int y) { return x <= y ? 0xFF : 0; });
#endif
}

// acc plus the sum over the four lanes of |lane read as a signed byte|: on
// the card one vabsdiff4 of the signed lanes against 0 with accumulate,
// exact at 0x80, which scores 128.
__host__ __device__ __forceinline__ uint32_t filter_add_score4(uint32_t acc, uint32_t v) {
#ifdef __CUDA_ARCH__
  uint32_t d;
  asm("vabsdiff4.u32.s32.s32.add %0, %1, %2, %3;" : "=r"(d) : "r"(v), "r"(0u), "r"(acc));
  return d;
#else
  for (int k = 0; k < 4; ++k) acc += (uint32_t)filter_score((int)((v >> (8 * k)) & 0xFFu));
  return acc;
#endif
}

// A word of 16-bit little-endian samples in PNG (big-endian) byte order:
// lane k takes memory lane k ^ 1.
__host__ __device__ __forceinline__ uint32_t filter_swap16(uint32_t w) {
#ifdef __CUDA_ARCH__
  return __byte_perm(w, 0u, 0x2301u);
#else
  return ((w & 0x00FF00FFu) << 8) | ((w >> 8) & 0x00FF00FFu);
#endif
}

// The Paeth predictor per lane (png-filter.ts:16-26) with byte compares
// only. pa = |b - c| and pb = |a - c| fit a byte; pc = |(b - c) + (a - c)|
// needs nine bits, but when the two differences have the same sign pc =
// pa + pb, so Paeth takes a if pa <= pb and else b; when their signs differ
// pc = |pa - pb|, and Paeth takes a if 2 pa <= pb, else b if 2 pb <= pa,
// else c (a zero difference fits both cases). 2 pa <= pb is pa <= pb >> 1.
__host__ __device__ __forceinline__ uint32_t filter_paeth4(uint32_t a, uint32_t b, uint32_t c) {
  const uint32_t pa = filter_absdiff4(b, c);
  const uint32_t pb = filter_absdiff4(a, c);
  const uint32_t same = ~(filter_ge4(b, c) ^ filter_ge4(a, c));
  const uint32_t half_pa = (pa >> 1) & 0x7F7F7F7Fu;
  const uint32_t half_pb = (pb >> 1) & 0x7F7F7F7Fu;
  const uint32_t ma = filter_le4(pa, (same & pb) | (~same & half_pb));
  const uint32_t mb = same | filter_le4(pb, half_pa);
  return (ma & a) | (~ma & ((mb & b) | (~mb & c)));
}

// Residue word of filter k for raw word x with left a, up b, upleft c.
__host__ __device__ __forceinline__ uint32_t filter_word_residue(int k, uint32_t x, uint32_t a,
                                                                 uint32_t b, uint32_t c) {
  switch (k) {
    case 0: return x;
    case 1: return filter_sub4(x, a);
    case 2: return filter_sub4(x, b);
    case 3: return filter_sub4(x, filter_avg4(a, b));
    default: return filter_sub4(x, filter_paeth4(a, b, c));
  }
}

// Adds the word's five scores to sums.
__host__ __device__ __forceinline__ void filter_word_scores(uint32_t x, uint32_t a, uint32_t b,
                                                            uint32_t c,
                                                            uint32_t sums[FILTER_COUNT]) {
  sums[0] = filter_add_score4(sums[0], x);
  sums[1] = filter_add_score4(sums[1], filter_sub4(x, a));
  sums[2] = filter_add_score4(sums[2], filter_sub4(x, b));
  sums[3] = filter_add_score4(sums[3], filter_sub4(x, filter_avg4(a, b)));
  sums[4] = filter_add_score4(sums[4], filter_sub4(x, filter_paeth4(a, b, c)));
}

// Word j of a row in PNG byte order (row start 4-byte aligned on the card).
__host__ __device__ __forceinline__ uint32_t filter_load_word(const uint8_t* row, int j, int swap) {
  uint32_t w;
#ifdef __CUDA_ARCH__
  w = ((const uint32_t*)row)[j];
#else
  memcpy(&w, row + 4 * (size_t)j, 4);
#endif
  return swap ? filter_swap16(w) : w;
}

// One row of n bytes (n % 4 == 0, bpp 4 or 8) in the word form, serially:
// the same result as filter_row_serial. Returns the filter type.
inline int filter_row_words(const uint8_t* raw, int raw_swap, const uint8_t* up, int up_swap,
                            int n, int bpp, uint8_t* out) {
  const int nw = n / 4;
  const int bw = bpp / 4;
  // Word j's left and upleft: word j - bw, or 0 in the first bpp bytes.
  auto left = [&](const uint8_t* row, int j, int swap) {
    return j >= bw ? filter_load_word(row, j - bw, swap) : 0u;
  };
  uint32_t sums[FILTER_COUNT] = {0, 0, 0, 0, 0};
  for (int j = 0; j < nw; ++j) {
    filter_word_scores(filter_load_word(raw, j, raw_swap), left(raw, j, raw_swap),
                       filter_load_word(up, j, up_swap), left(up, j, up_swap), sums);
  }
  int s[FILTER_COUNT];
  for (int k = 0; k < FILTER_COUNT; ++k) s[k] = (int)sums[k];
  const int choice = filter_choose(s);
  for (int j = 0; j < nw; ++j) {
    const uint32_t r = filter_word_residue(choice, filter_load_word(raw, j, raw_swap),
                                           left(raw, j, raw_swap),
                                           filter_load_word(up, j, up_swap), left(up, j, up_swap));
    memcpy(out + 4 * (size_t)j, &r, 4);
  }
  return choice;
}
