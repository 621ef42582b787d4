// JPEG encode: colour conversion, forward DCT and quantization of a band on
// Hopper.
//
// Replaces the XLA program of image_stitch_tpu/ops/device.py:204
// jpeg_quantize_trace and :224 jpeg_quantize_420_trace
// (ops/jpeg_dct.py band_to_blocks_islow and _420): integer YCbCr planes,
// the two butterfly passes over strided views of the planes, the quantizer
// broadcast over the band and the block relayout, each a pass over device
// memory. Here the band is read once and the blocks are written once.
//
// What bounds it on the H100: 3-4 B a pixel in and 6 B (4:4:4) or 3 B
// (4:2:0) of coefficients out, 21.0 MB for a 256 x 8192 RGBA band; but each
// pixel also costs some hundred integer instructions (colour, two passes of
// three components, the quantizer), which at four warp instructions a cycle
// on each of 132 SMs is of the same order as the bytes. So the design
// spends as few instructions and as little latency per pixel as it can:
// - a CTA of 128 threads takes a strip tile of 128 pixels by one MCU row (8
//   rows, 16 blocks a component; 4:2:0: 16 rows, 8 MCUs), so a 256 x 8192
//   band is 2,048 CTAs and an SM holds many of them;
// - a thread loads one row of 8 pixels as one or two 16 B words (RGBA), three
//   8 B words (RGB) or bytes, whichever the band's pixel stride and address
//   allow (kVariant; the wrapper chooses, the launcher checks). The 8
//   threads of a block read 8 rows, each a whole 32 B sector, and nobody
//   else reads those bytes, so nothing is gained by staging the raw tile in
//   shared memory with cp.async or a TMA tensor map: both are left out;
// - it converts each pixel once, to all three components, and runs their
//   row passes in registers (fdct_row_444; fdct_patch_420 for two rows and
//   their 2x2 chroma boxes): 8 values a component, never a block;
// - the rows meet in shared memory (rows padded by 4 words, so that the 8
//   row threads of a block and the 32 column threads of a warp hit distinct
//   banks); a thread then takes one column of a block: column pass and
//   quantizer (fdct_column), the division as a 32-bit reciprocal made once
//   per CTA and table entry, __umulhi and a one-sided correction;
// - the coefficients leave through a shared staging row per block as 16 B
//   per thread, consecutive threads on consecutive addresses, in the
//   encoder's block orders (strip-major for 4:4:4; TL, TR, BL, BR per MCU
//   for 4:2:0 luma): a tile's blocks of one component are contiguous.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fdct_quant.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTileBlocks = kThreads / 8;     // blocks of a component across a tile
constexpr int kTilePx = kTileBlocks * 8;      // pixels across a tile
constexpr int kRowStride = kTilePx + 4;       // words of a plane row in shared memory
constexpr int kHalfStride = kTilePx / 2 + 4;  // the same for a 4:2:0 chroma plane
constexpr int kStageStride = 72;              // int16 of a staged block (64 and 8 of padding)

// How a thread reads its 8 pixels: bytes (any pixel stride and address),
// three 8 B words (RGB, 8 B aligned), two 16 B words (RGBA, 16 B aligned).
enum { kBytes = 0, kRgb8 = 1, kRgba16 = 2 };

template <int kVariant>
__device__ __forceinline__ void load8(const uint8_t* __restrict__ p, int ch, int32_t r[8],
                                      int32_t g[8], int32_t b[8]) {
  if (kVariant == kRgba16) {
    uint32_t w[8];
    *reinterpret_cast<uint4*>(w) = __ldg(reinterpret_cast<const uint4*>(p));
    *reinterpret_cast<uint4*>(w + 4) = __ldg(reinterpret_cast<const uint4*>(p) + 1);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      r[i] = w[i] & 0xffu;
      g[i] = (w[i] >> 8) & 0xffu;
      b[i] = (w[i] >> 16) & 0xffu;
    }
  } else if (kVariant == kRgb8) {
    uint32_t w[6];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p) + k);
      w[2 * k] = v.x;
      w[2 * k + 1] = v.y;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      r[i] = (w[(3 * i) >> 2] >> (8 * ((3 * i) & 3))) & 0xffu;
      g[i] = (w[(3 * i + 1) >> 2] >> (8 * ((3 * i + 1) & 3))) & 0xffu;
      b[i] = (w[(3 * i + 2) >> 2] >> (8 * ((3 * i + 2) & 3))) & 0xffu;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      r[i] = p[i * ch];
      g[i] = p[i * ch + 1];
      b[i] = p[i * ch + 2];
    }
  }
}

__device__ __forceinline__ void store8(int32_t* dst, const int32_t v[8]) {
  *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<int4*>(dst + 4) = make_int4(v[4], v[5], v[6], v[7]);
}

// The tables and their reciprocals, once per CTA: [0] luma, [1] chroma.
__device__ __forceinline__ void stage_tables(const int32_t* __restrict__ lq,
                                             const int32_t* __restrict__ cq, int32_t (*q_s)[64],
                                             uint32_t (*m_s)[64]) {
  const int t = threadIdx.x >> 6, i = threadIdx.x & 63;
  const int32_t q = (t ? cq : lq)[i];
  q_s[t][i] = q;
  m_s[t][i] = fdct_recip(q);
}

// Column c of the block whose rows start at `plane` (row stride `stride`):
// pass, quantize with table t, into the staged block `slot`.
__device__ __forceinline__ void column_task(const int32_t* plane, int stride, int c, int t,
                                            const int32_t (*q_s)[64], const uint32_t (*m_s)[64],
                                            int16_t* stage, int slot) {
  int32_t v[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) v[r] = plane[r * stride + c];
  fdct_column(v, c, q_s[t], m_s[t], stage + slot * kStageStride + c, 8);
}

// 16 B number `part` of staged block `slot` to block `index` of `out`.
__device__ __forceinline__ void store_part(const int16_t* stage, int slot, int part,
                                           int16_t* __restrict__ out, size_t index) {
  reinterpret_cast<int4*>(out + index * 64)[part] =
      *reinterpret_cast<const int4*>(stage + slot * kStageStride + part * 8);
}

template <int kVariant>
__global__ void __launch_bounds__(kThreads)
    fdct_quant_444_kernel(const uint8_t* __restrict__ band, int w, int ch,
                          const int32_t* __restrict__ lq, const int32_t* __restrict__ cq,
                          int16_t* __restrict__ y_out, int16_t* __restrict__ cb_out,
                          int16_t* __restrict__ cr_out) {
  __shared__ __align__(16) int32_t plane[3][8 * kRowStride];
  __shared__ __align__(16) int16_t stage[3][kTileBlocks * kStageStride];
  __shared__ int32_t q_s[2][64];
  __shared__ uint32_t m_s[2][64];
  stage_tables(lq, cq, q_s, m_s);
  const int bpr = w / 8;
  const int tiles = (bpr + kTileBlocks - 1) / kTileBlocks;
  const int strip = blockIdx.x / tiles;
  const int b0 = (blockIdx.x - strip * tiles) * kTileBlocks;
  const int b = threadIdx.x >> 3, k = threadIdx.x & 7;  // block of the tile; row, then column
  const bool live = b0 + b < bpr;  // the last tile of a strip may be ragged
  if (live) {
    int32_t r[8], g[8], bl[8], y[8], cb[8], cr[8];
    load8<kVariant>(band + ((size_t)(strip * 8 + k) * w + (size_t)(b0 + b) * 8) * ch, ch, r, g,
                    bl);
    fdct_row_444(r, g, bl, y, cb, cr);
    const int at = k * kRowStride + b * 8;
    store8(plane[0] + at, y);
    store8(plane[1] + at, cb);
    store8(plane[2] + at, cr);
  }
  __syncthreads();
  if (live) {
#pragma unroll
    for (int comp = 0; comp < 3; ++comp) {
      column_task(plane[comp] + b * 8, kRowStride, k, comp != 0, q_s, m_s, stage[comp], b);
    }
  }
  __syncthreads();
  if (live) {
    const size_t index = (size_t)strip * bpr + b0 + b;
    store_part(stage[0], b, k, y_out, index);
    store_part(stage[1], b, k, cb_out, index);
    store_part(stage[2], b, k, cr_out, index);
  }
}

template <int kVariant>
__global__ void __launch_bounds__(kThreads)
    fdct_quant_420_kernel(const uint8_t* __restrict__ band, int w, int ch,
                          const int32_t* __restrict__ lq, const int32_t* __restrict__ cq,
                          int16_t* __restrict__ y_out, int16_t* __restrict__ cb_out,
                          int16_t* __restrict__ cr_out) {
  constexpr int kTileMcus = kTileBlocks / 2;
  __shared__ __align__(16) int32_t luma[16 * kRowStride];
  __shared__ __align__(16) int32_t chroma[2][8 * kHalfStride];
  // Staged blocks: 4 luma blocks per MCU in MCU order, then Cb, then Cr.
  __shared__ __align__(16) int16_t stage[6 * kTileMcus * kStageStride];
  __shared__ int32_t q_s[2][64];
  __shared__ uint32_t m_s[2][64];
  stage_tables(lq, cq, q_s, m_s);
  const int mpr = w / 16;
  const int tiles = (mpr + kTileMcus - 1) / kTileMcus;
  const int mrow = blockIdx.x / tiles;
  const int m0 = (blockIdx.x - mrow * tiles) * kTileMcus;
  const int n_mcu = min(kTileMcus, mpr - m0);  // the last tile of a row may be ragged
  const int hi = threadIdx.x >> 3, k = threadIdx.x & 7;
  // Rows 2k and 2k + 1 of the 8-pixel column group `hi`: two luma rows and
  // four boxes of chroma row k.
  if (hi < 2 * n_mcu) {
    int32_t px[2][3][8], y[2][8], cb[4], cr[4];
    const uint8_t* p = band + ((size_t)(mrow * 16 + 2 * k) * w + (size_t)(m0 * 2 + hi) * 8) * ch;
    load8<kVariant>(p, ch, px[0][0], px[0][1], px[0][2]);
    load8<kVariant>(p + (size_t)w * ch, ch, px[1][0], px[1][1], px[1][2]);
    fdct_patch_420(px, y, cb, cr);
    store8(luma + (2 * k) * kRowStride + hi * 8, y[0]);
    store8(luma + (2 * k + 1) * kRowStride + hi * 8, y[1]);
    const int at = k * kHalfStride + hi * 4;
    *reinterpret_cast<int4*>(chroma[0] + at) = make_int4(cb[0], cb[1], cb[2], cb[3]);
    *reinterpret_cast<int4*>(chroma[1] + at) = make_int4(cr[0], cr[1], cr[2], cr[3]);
  }
  __syncthreads();
  // Row k of chroma block `hi`: Cb of MCU hi, or Cr of MCU hi - kTileMcus.
  {
    const int comp = hi >= kTileMcus, mcu = hi - comp * kTileMcus;
    if (mcu < n_mcu) fdct_pass(chroma[comp] + k * kHalfStride + mcu * 8, 1, false);
  }
  __syncthreads();
  // Columns: 32 luma blocks in plane order (so that a warp reads
  // consecutive words), then 16 chroma blocks.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pb = hi + i * kTileBlocks;  // block row i, block column hi
    const int mcu = hi >> 1;
    if (mcu < n_mcu) {
      column_task(luma + i * 8 * kRowStride + hi * 8, kRowStride, k, 0, q_s, m_s, stage,
                  mcu * 4 + i * 2 + (pb & 1));
    }
  }
  {
    const int comp = hi >= kTileMcus, mcu = hi - comp * kTileMcus;
    if (mcu < n_mcu) {
      column_task(chroma[comp] + mcu * 8, kHalfStride, k, 1, q_s, m_s, stage,
                  (4 + comp) * kTileMcus + mcu);
    }
  }
  __syncthreads();
  const size_t mcu_index = (size_t)mrow * mpr + m0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int slot = hi + i * kTileBlocks;  // the tile's luma blocks in MCU order
    if (slot < 4 * n_mcu) store_part(stage, slot, k, y_out, mcu_index * 4 + slot);
  }
  {
    const int comp = hi >= kTileMcus, mcu = hi - comp * kTileMcus;
    if (mcu < n_mcu) {
      store_part(stage, (4 + comp) * kTileMcus + mcu, k, comp ? cr_out : cb_out,
                 mcu_index + mcu);
    }
  }
}

template <int kVariant>
void launch(const uint8_t* band, int h, int w, int ch, const int32_t* lq, const int32_t* cq,
            int s420, int16_t* y, int16_t* cb, int16_t* cr, cudaStream_t stream) {
  if (s420) {
    const int tiles = (w / 16 + kTileBlocks / 2 - 1) / (kTileBlocks / 2);
    fdct_quant_420_kernel<kVariant><<<(h / 16) * tiles, kThreads, 0, stream>>>(
        band, w, ch, lq, cq, y, cb, cr);
  } else {
    const int tiles = (w / 8 + kTileBlocks - 1) / kTileBlocks;
    fdct_quant_444_kernel<kVariant><<<(h / 8) * tiles, kThreads, 0, stream>>>(
        band, w, ch, lq, cq, y, cb, cr);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a variant the band does not allow.
// band: (h, w, ch) uint8, ch >= 3; h and w multiples of 8 (4:4:4) or 16
// (4:2:0); lq, cq: (64,) int32 natural-order tables, each entry from 1 to
// 2^28; variant: 0 byte loads, 1 three 8 B loads per 8 pixels (ch 3, band
// 8 B aligned), 2 two 16 B loads (ch 4, band 16 B aligned); y, cb, cr: the
// blocks, (n, 64) int16 each, 16 B aligned.
extern "C" int fdct_quant_launch(const uint8_t* band, int h, int w, int ch, const int32_t* lq,
                                 const int32_t* cq, int s420, int variant, int16_t* y,
                                 int16_t* cb, int16_t* cr, void* stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(band);
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == kRgba16 && ch == 4 && addr % 16 == 0) {
    launch<kRgba16>(band, h, w, ch, lq, cq, s420, y, cb, cr, s);
  } else if (variant == kRgb8 && ch == 3 && addr % 8 == 0) {
    launch<kRgb8>(band, h, w, ch, lq, cq, s420, y, cb, cr, s);
  } else if (variant == kBytes) {
    launch<kBytes>(band, h, w, ch, lq, cq, s420, y, cb, cr, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
