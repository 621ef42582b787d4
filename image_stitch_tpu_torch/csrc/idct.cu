// JPEG decode: dequantize and islow IDCT of one component's band window on
// Hopper.
//
// Replaces the XLA program image_stitch_tpu/ops/jpeg_idct_device.py:521
// decode_plane_trace (dezigzag_pad_t, dequantize, the two-limb butterfly
// IDCT idct_islow_exact_t, the range limit, _assemble_plane_t). The TPU had
// no int64, so it split every value into two int32 limbs and proved them
// exact up to M_SAFE; here the butterflies run in int64 (idct.cuh), exact for
// any int16 coefficient, and the plane is written in place, so no transpose
// or assembly pass is left.
//
// Eight threads per 8x8 block, 32 blocks per CTA. Thread c of a block takes
// column c: it gathers the column's 8 coefficients from the block's k
// zigzag-prefix values (the table of natural -> zigzag positions and the
// quantizer in shared memory), dequantizes and runs the column pass into a
// shared int64 workspace; after __syncthreads thread r takes row r through
// the row pass and the range limit and stores its 8 samples with one 8 B
// store.
//
// What bounds it on the H100: bytes. A 256-row band window of an 8192-wide
// 4:2:0 tile row moves k * 2 B of coefficients per block in and 64 B of
// samples out (k = 24..40 on photo content at q90); the int64 arithmetic
// (about 2 x 8 x 40 multiply-adds per block, each a few 32-bit
// instructions) comes second. A simple kernel first; not tuned.
#include <cuda_runtime.h>
#include <stdint.h>

#include "idct.cuh"

namespace {

constexpr int kBlocksPerCta = 32;
constexpr int kThreads = kBlocksPerCta * 8;

__constant__ uint8_t kNatToZz[64] = JPEG_NATURAL_TO_ZIGZAG;

__global__ void __launch_bounds__(kThreads)
    idct_dequant_kernel(const int16_t* __restrict__ zz, int n_blocks, int k,
                        const int32_t* __restrict__ q, int bx, uint8_t* __restrict__ out) {
  __shared__ int32_t q_s[64];
  __shared__ uint8_t nat_to_zz[64];
  // [block][row][column], the column padded to 9 against bank conflicts.
  __shared__ int64_t ws_s[kBlocksPerCta][8][9];
  if (threadIdx.x < 64) {
    q_s[threadIdx.x] = q[threadIdx.x];
    nat_to_zz[threadIdx.x] = kNatToZz[threadIdx.x];
  }
  __syncthreads();
  const int local = threadIdx.x >> 3;
  const int lane8 = threadIdx.x & 7;
  const int b = blockIdx.x * kBlocksPerCta + local;
  const bool live = b < n_blocks;
  if (live) {
    int64_t ws[8];
    idct_column(zz + (size_t)b * (size_t)k, k, q_s, nat_to_zz, lane8, ws);
#pragma unroll
    for (int r = 0; r < 8; ++r) ws_s[local][r][lane8] = ws[r];
  }
  __syncthreads();
  if (!live) return;
  int64_t v[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) v[c] = ws_s[local][lane8][c];
  uint8_t px[8];
  idct_row(v, px);
  const int by = b / bx, bxi = b - by * bx;
  const size_t row = (size_t)(by * 8 + lane8) * (size_t)(bx * 8);
  uint2 word;
  word.x = (uint32_t)px[0] | ((uint32_t)px[1] << 8) | ((uint32_t)px[2] << 16) |
           ((uint32_t)px[3] << 24);
  word.y = (uint32_t)px[4] | ((uint32_t)px[5] << 8) | ((uint32_t)px[6] << 16) |
           ((uint32_t)px[7] << 24);
  *reinterpret_cast<uint2*>(out + row + (size_t)bxi * 8) = word;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// zz: (n_blocks, k) int16, whole block rows of bx blocks; q: (64,) int32
// natural order; out: (n_blocks / bx * 8, bx * 8) uint8, 8 B aligned.
extern "C" int idct_dequant_launch(const int16_t* zz, int n_blocks, int k, const int32_t* q,
                                   int bx, uint8_t* out, void* stream) {
  const int ctas = (n_blocks + kBlocksPerCta - 1) / kBlocksPerCta;
  idct_dequant_kernel<<<ctas, kThreads, 0, (cudaStream_t)stream>>>(zz, n_blocks, k, q, bx, out);
  return (int)cudaGetLastError();
}
