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

// The sums of one 8-point pass of jidctint.c's butterfly over v[0..7], in
// place, before the descale, in the unsigned type U (uint64_t or uint32_t)
// with S the signed type of the same width: sums and products wrap, so what
// comes out is the true value modulo 2^64 or 2^32, with no signed overflow
// anywhere.
template <typename U, typename S>
__host__ __device__ __forceinline__ void idct_islow_sums_t(U v[8]) {
  const U one = (U)1 << IDCT_CONST_BITS;
  U z2 = v[2], z3 = v[6];
  U z1 = (z2 + z3) * (U)4433;                       // FIX_0_541196100
  const U tmp2 = z1 + z3 * (U)(S)-15137;            // FIX_1_847759065
  const U tmp3 = z1 + z2 * (U)6270;                 // FIX_0_765366865
  const U tmp0 = (v[0] + v[4]) * one;
  const U tmp1 = (v[0] - v[4]) * one;
  const U tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const U tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

  U t0 = v[7], t1 = v[5], t2 = v[3], t3 = v[1];
  z1 = t0 + t3;
  z2 = t1 + t2;
  z3 = t0 + t2;
  U z4 = t1 + t3;
  const U z5 = (z3 + z4) * (U)9633;                 // FIX_1_175875602
  t0 *= (U)2446;                                    // FIX_0_298631336
  t1 *= (U)16819;                                   // FIX_2_053119869
  t2 *= (U)25172;                                   // FIX_3_072711026
  t3 *= (U)12299;                                   // FIX_1_501321110
  z1 *= (U)(S)-7373;                                // FIX_0_899976223
  z2 *= (U)(S)-20995;                               // FIX_2_562915447
  z3 = z3 * (U)(S)-16069 + z5;                      // FIX_1_961570560
  z4 = z4 * (U)(S)-3196 + z5;                       // FIX_0_390180644
  t0 += z1 + z3;
  t1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1 + z4;

  v[0] = tmp10 + t3;
  v[7] = tmp10 - t3;
  v[1] = tmp11 + t2;
  v[6] = tmp11 - t2;
  v[2] = tmp12 + t1;
  v[5] = tmp12 - t1;
  v[3] = tmp13 + t0;
  v[4] = tmp13 - t0;
}

// One pass: the sums, descaled by n bits (round half up) with the
// arithmetic shift of S.
template <typename U, typename S>
__host__ __device__ __forceinline__ void idct_islow_pass_t(U v[8], int n) {
  idct_islow_sums_t<U, S>(v);
  const U round = (U)1 << (n - 1);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = (U)((S)(v[i] + round) >> n);
}

// The pass over int64 values: exact for every int16 coefficient times every
// 16-bit quantizer, in both passes.
__host__ __device__ __forceinline__ void idct_islow_pass(int64_t v[8], int n) {
  uint64_t u[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) u[i] = (uint64_t)v[i];
  idct_islow_pass_t<uint64_t, int64_t>(u, n);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = (int64_t)u[i];
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

// ---- the form the card runs (idct.cu), also in 32 bits ------------------- //
//
// Where 32 bits are enough, and why the result stays exact:
//
// - A dequantized value d = coefficient * quantizer lies in (-2^31, 2^31) for
//   every int16 coefficient and 16-bit quantizer (32768 * 65535 < 2^31), so
//   the staged d is an int32 in every case.
// - The row pass ends in POST[((x + 2^17) >> 18) & 1023]: of the pass's
//   value x only bits 18..27 are read. Sums and products modulo 2^32 keep
//   the low 32 bits of the true x, so the row pass in uint32_t is exact for
//   every input, provided it gets the column pass's outputs modulo 2^32.
//   The workspace between the passes is therefore 32 bits wide.
// - The column pass gives ws = (X + 2^10) >> 11, of which the low 32 bits
//   are needed: bits 11..42 of X. Each X is a sum of a_i * d_i over the
//   column's 8 values, and the largest sum of |a_i| over the 8 outputs is
//   IDCT_PASS_L1 = 61214 (pinned by the tests: the pass applied to the unit
//   vectors). With every |d_i| <= IDCT_INT32_MAX_DEQ = 32767,
//   |X + 2^10| <= 61214 * 32767 + 1024 < 2^31: X, computed modulo 2^32, is
//   the true X, and the int32 arithmetic shift gives the true ws. A job
//   whose max |coefficient| * max quantizer is within that bound carries
//   IDCT_JOB_INT32 and runs the column pass in uint32_t; any other job runs
//   it in uint64_t, exact as idct_column above, and keeps the low 32 bits.
#define IDCT_PASS_L1 61214
#define IDCT_INT32_MAX_DEQ 32767

// A job of the batched kernel is one (tile, component) window of a band; the
// kernel reads a table with one row of IDCT_CTA_COLS int32 per CTA, which
// holds what is uniform in the CTA, so that a thread reaches its
// coefficients after one dependent load and needs no division.
#define IDCT_CTA_COLS 8
#define IDCT_CTA_COEF 0    // the CTA's first coefficient, in int16 elements, % 8 == 0
#define IDCT_CTA_LIVE 1    // its blocks, 1..IDCT_CTA_BLOCKS
#define IDCT_CTA_K 2       // coefficients kept a block, a multiple of 8
#define IDCT_CTA_QTAB 3    // which (64,) zigzag-order quantizer table
#define IDCT_CTA_BX 4      // blocks a row of the job's plane
#define IDCT_CTA_PLANE 5   // first byte of the block row of its first block, % 16 == 0
#define IDCT_CTA_BXI 6     // its first block's place in that block row
#define IDCT_CTA_FLAGS 7
#define IDCT_JOB_INT32 1   // flag: the column pass is exact in 32 bits
// Blocks of one CTA, and the words of a block's workspace: 8 rows padded to
// 9 words, 72 a block, so that neither pass meets a bank conflict.
#define IDCT_CTA_BLOCKS 16
#define IDCT_WS_ROW 9
#define IDCT_WS_BLOCK 72

// Where the samples of row r of the CTA's block `local` go: the plane's byte
// offset. The block lies `local` places after the CTA's first block, in its
// block row or, past that row's end, in one of the next.
__host__ __device__ __forceinline__ size_t idct_block_row_at(const int32_t* cta, int local,
                                                             int r) {
  const int bx = cta[IDCT_CTA_BX];
  int bxi = cta[IDCT_CTA_BXI] + local, rows = r;
  while (bxi >= bx) {
    bxi -= bx;
    rows += 8;
  }
  return (size_t)cta[IDCT_CTA_PLANE] + (size_t)rows * (size_t)(bx * 8) + (size_t)bxi * 8;
}

// The workspace index of each zigzag position j: idct_ws_at of its natural
// position, JPEG_ZIGZAG_ORDER[j] + JPEG_ZIGZAG_ORDER[j] / 8.
#define IDCT_ZIGZAG_WS                                                      \
  {0,  1,  9,  18, 10, 2,  3,  11, 19, 27, 36, 28, 20, 12, 4,  5,           \
   13, 21, 29, 37, 45, 54, 46, 38, 30, 22, 14, 6,  7,  15, 23, 31,          \
   39, 47, 55, 63, 64, 56, 48, 40, 32, 24, 16, 25, 33, 41, 49, 57,          \
   65, 66, 58, 50, 42, 34, 43, 51, 59, 67, 68, 60, 52, 61, 69, 70}

// Workspace index of the natural position (r, c) of a block.
__host__ __device__ __forceinline__ int idct_ws_at(int r, int c) { return r * IDCT_WS_ROW + c; }

// A chunk of a block: 8 consecutive zigzag positions `zz8` (zeros for a
// chunk at or past k / 8), times their zigzag-order quantizers `q8`, each
// product stored at its workspace index `ws8[i]` (IDCT_ZIGZAG_WS): the
// dezigzag.
__host__ __device__ __forceinline__ void idct_stage_chunk(const int16_t zz8[8],
                                                          const int32_t q8[8],
                                                          const uint8_t ws8[8], uint32_t* ws) {
#pragma unroll
  for (int i = 0; i < 8; ++i) ws[ws8[i]] = (uint32_t)((int32_t)zz8[i] * q8[i]);
}

// Column c of the block's workspace through the column pass, in place, in 32
// bits (`narrow`, IDCT_JOB_INT32) or 64.
__host__ __device__ __forceinline__ void idct_column_ws(uint32_t* ws, int c, bool narrow) {
  if (narrow) {
    uint32_t v[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) v[r] = ws[idct_ws_at(r, c)];
    idct_islow_pass_t<uint32_t, int32_t>(v, IDCT_CONST_BITS - IDCT_PASS1_BITS);
#pragma unroll
    for (int r = 0; r < 8; ++r) ws[idct_ws_at(r, c)] = v[r];
  } else {
    uint64_t v[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) v[r] = (uint64_t)(int64_t)(int32_t)ws[idct_ws_at(r, c)];
    idct_islow_pass_t<uint64_t, int64_t>(v, IDCT_CONST_BITS - IDCT_PASS1_BITS);
#pragma unroll
    for (int r = 0; r < 8; ++r) ws[idct_ws_at(r, c)] = (uint32_t)v[r];
  }
}

// The range limit of a row-pass value known modulo 2^32: POST[x & 1023] is
// the 10-bit two's complement value of x, plus 128, clamped to 0..255.
__host__ __device__ __forceinline__ uint32_t idct_range_limit_u32(uint32_t x) {
  const int32_t s = ((int32_t)(x << 22) >> 22) + 128;
  return (uint32_t)(s < 0 ? 0 : (s > 255 ? 255 : s));
}

// Four values clamped to 0..255 and packed little-endian into a word: on
// the card two cvt.pack.sat instructions.
__host__ __device__ __forceinline__ uint32_t idct_pack_sat4(int32_t a, int32_t b, int32_t c,
                                                            int32_t d) {
#ifdef __CUDA_ARCH__
  uint32_t hi, word;
  asm("cvt.pack.sat.u8.s32.b32 %0, %1, %2, %3;" : "=r"(hi) : "r"(d), "r"(c), "r"(0));
  asm("cvt.pack.sat.u8.s32.b32 %0, %1, %2, %3;" : "=r"(word) : "r"(b), "r"(a), "r"(hi));
  return word;
#else
  const int32_t v[4] = {a, b, c, d};
  uint32_t word = 0;
  for (int i = 0; i < 4; ++i) {
    word |= (uint32_t)(v[i] < 0 ? 0 : (v[i] > 255 ? 255 : v[i])) << (8 * i);
  }
  return word;
#endif
}

// Row r of the block's workspace through the row pass and the range limit
// into 8 samples, packed little-endian into two words. Of a sum x the pass
// needs bits 18..27 of x + 2^17 as a signed 10-bit value: shifted to the
// top of the word and back, which is idct_range_limit_u32 of the descaled
// value without its clamp.
__host__ __device__ __forceinline__ void idct_row_ws(const uint32_t* ws, int r,
                                                     uint32_t out[2]) {
  uint32_t v[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) v[c] = ws[idct_ws_at(r, c)];
  idct_islow_sums_t<uint32_t, int32_t>(v);
  const int n = IDCT_CONST_BITS + IDCT_PASS1_BITS + 3;
  int32_t s[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    s[c] = ((int32_t)((v[c] + (1u << (n - 1))) << (22 - n)) >> 22) + 128;
  }
  out[0] = idct_pack_sat4(s[0], s[1], s[2], s[3]);
  out[1] = idct_pack_sat4(s[4], s[5], s[6], s[7]);
}
