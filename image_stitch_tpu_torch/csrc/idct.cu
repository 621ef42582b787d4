// JPEG decode: dequantize and islow IDCT of every (tile, component) window of
// a band on Hopper, in one launch.
//
// Replaces the XLA program image_stitch_tpu/ops/jpeg_idct_device.py:521
// decode_plane_trace (dezigzag_pad_t, dequantize, the two-limb butterfly
// IDCT idct_islow_exact_t, the range limit, _assemble_plane_t), which the
// JAX package runs once per tile and component. The TPU had no int64, so it
// split every value into two int32 limbs and proved them exact up to M_SAFE.
// Here each window is a job: where its coefficients start in the band's
// coefficient buffer, its block count, k, its quantizer table, its blocks a
// row and where its plane starts in the band's plane buffer. One launch
// runs all of a band's jobs: a band of 8 4:2:0 tiles of 1024 columns is 24
// jobs, 51,200 blocks, 3200 CTAs, some 24 to an SM, where one launch per
// window was less than one wave.
//
// A CTA holds 16 consecutive blocks of one job, 8 threads a block. A table
// in the same upload has a row per CTA (idct.cuh IDCT_CTA_*) with what is
// uniform in it (k, bx, the quantizer, where its blocks' coefficients and
// samples lie), so a thread reaches its coefficients after one dependent
// load and divides nothing. Thread (block b, j):
// 1. loads chunk j of the block, its zigzag positions 8j..8j+7, with one
//    16 B load (k is a multiple of 8 and a job starts at a 16 B boundary, so
//    a CTA reads one contiguous run, coalesced), multiplies by the
//    zigzag-order quantizers (two 16 B loads, the same for every block) and
//    stores each product at its natural position in the block's shared
//    workspace (a table gives each zigzag position's workspace index): the
//    dezigzag is this scatter. Chunks past k store zeros.
// 2. after __syncwarp (a block's 8 threads share a warp) takes column j
//    through the column pass, in place;
// 3. after __syncwarp takes row j through the row pass and the range limit
//    (a shift pair and cvt.pack.sat, four samples in two instructions) and
//    stores its 8 samples with one 8 B store; a warp's four blocks lie
//    side by side, so each row of a warp is a whole 32 B sector.
// There is no __syncthreads.
//
// What bounds it on the H100: bytes (2k B of coefficients in and 64 B of
// samples out per block: 0.0030 ms for the 51,200 blocks above at K 64) and,
// just above them, instruction issue: the 32-bit path is 265 SASS
// instructions a thread, 66 warp instructions a block, 6400 cycles an SM at
// four issues a cycle, some 0.0035 ms. The design keeps the issue near the
// bytes: the workspace is 32 bits wide (4.5 KB a CTA, half of an int64 one;
// rows padded to 9 words and blocks to 72 so that neither pass meets a bank
// conflict), the row pass runs in uint32_t for every input and the column
// pass does where the job's flag says it is exact; idct.cuh proves both.
// Other jobs run the column pass in uint64_t (105 instructions in place of
// 60), so every int16 coefficient times every 16-bit quantizer decodes
// exactly, as before. Measured: 0.0061 ms on that band (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

#include "idct.cuh"

namespace {

constexpr int kThreads = IDCT_CTA_BLOCKS * 8;

// Read 8 B a thread, a different chunk in each of a block's threads: global
// memory through L1, since constant memory would serialize the 8 addresses.
__device__ __align__(8) const uint8_t kZzToWs[64] = IDCT_ZIGZAG_WS;

__global__ void __launch_bounds__(kThreads)
    idct_dequant_batch_kernel(const int16_t* __restrict__ coefs,
                              const int32_t* __restrict__ qtabs,
                              const int32_t* __restrict__ ctas, uint8_t* __restrict__ planes) {
  __shared__ uint32_t ws_s[IDCT_CTA_BLOCKS * IDCT_WS_BLOCK];
  const int4* row4 = reinterpret_cast<const int4*>(ctas + (size_t)blockIdx.x * IDCT_CTA_COLS);
  const int4 ca = row4[0];  // coefficients, live blocks, k, quantizer table
  const int4 cb = row4[1];  // bx, plane, first block's place, flags
  const int32_t cta[IDCT_CTA_COLS] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, cb.z, cb.w};
  const int k = cta[IDCT_CTA_K];
  const int local = threadIdx.x >> 3;
  const int j = threadIdx.x & 7;
  if (local >= cta[IDCT_CTA_LIVE]) return;  // whole blocks leave: the syncs are per warp
  uint32_t* ws = ws_s + local * IDCT_WS_BLOCK;

  int16_t zz8[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  int32_t q8[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (8 * j < k) {
    const uint4 c = *reinterpret_cast<const uint4*>(
        coefs + (size_t)cta[IDCT_CTA_COEF] + (size_t)(local * k + 8 * j));
    const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      zz8[2 * i] = (int16_t)(w[i] & 0xFFFFu);
      zz8[2 * i + 1] = (int16_t)(w[i] >> 16);
    }
    const int4* q4 =
        reinterpret_cast<const int4*>(qtabs + (size_t)cta[IDCT_CTA_QTAB] * 64 + 8 * j);
    const int4 qa = q4[0], qb = q4[1];
    q8[0] = qa.x, q8[1] = qa.y, q8[2] = qa.z, q8[3] = qa.w;
    q8[4] = qb.x, q8[5] = qb.y, q8[6] = qb.z, q8[7] = qb.w;
  }
  const uint2 n2 = reinterpret_cast<const uint2*>(kZzToWs)[j];
  uint8_t ws8[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ws8[i] = (uint8_t)(n2.x >> (8 * i));
    ws8[4 + i] = (uint8_t)(n2.y >> (8 * i));
  }
  idct_stage_chunk(zz8, q8, ws8, ws);
  __syncwarp();
  idct_column_ws(ws, j, (cta[IDCT_CTA_FLAGS] & IDCT_JOB_INT32) != 0);
  __syncwarp();
  uint32_t px[2];
  idct_row_ws(ws, j, px);
  *reinterpret_cast<uint2*>(planes + idct_block_row_at(cta, local, j)) = make_uint2(px[0], px[1]);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// coefs: the band's int16 coefficients, 16 B aligned; qtabs: (n, 64) int32
// quantizers in zigzag order, 16 B aligned; ctas: (n_ctas, IDCT_CTA_COLS)
// int32, 16 B aligned; planes: the band's plane buffer, 16 B aligned. All on
// the device.
extern "C" int idct_dequant_batch_launch(const int16_t* coefs, const int32_t* qtabs,
                                         const int32_t* ctas, int n_ctas, uint8_t* planes,
                                         void* stream) {
  idct_dequant_batch_kernel<<<n_ctas, kThreads, 0, (cudaStream_t)stream>>>(coefs, qtabs, ctas,
                                                                           planes);
  return (int)cudaGetLastError();
}
