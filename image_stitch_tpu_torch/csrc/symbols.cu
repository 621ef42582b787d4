// JPEG encode: the Huffman symbol streams of a band on Hopper.
//
// Replaces the XLA programs image_stitch_tpu/ops/jpeg_entropy_device.py:560
// _symbol_streams_flat (restart groups) and :286 _symbol_streams (one
// carried stream): the zigzag gather, the DC differences, a cumulative max
// over the AC positions for the run lengths, and table gathers for the
// codes, each a pass over a (B, 64) array; in torch about 60 launches per
// band.
//
// One thread per block of the MCU sequence. It finds its component block
// (symbols.cuh symbol_block_source) and the previous block of the same
// component, whose DC gives the difference: no scan. The DC chain starts
// from 0 at each restart group (every group_len blocks of the component), or
// from prev_dc[comp] for the carried stream. The thread then walks its
// block's 63 AC positions in order (symbol_block), with the tables and the
// zigzag order in shared memory, writing its 65 slots into a shared row;
// the CTA then copies its rows out with consecutive threads on consecutive
// words.
//
// What bounds it on the H100: bytes, 128 B of coefficients in and 520 B of
// codes and lengths out per block (51.1 MB for a 256 x 8192 4:4:4 band);
// the serial walk over 64 positions per thread comes next. A simple kernel
// first; not tuned.
#include <cuda_runtime.h>
#include <stdint.h>

#include "idct.cuh"
#include "symbols.cuh"

namespace {

constexpr int kThreads = 64;

__constant__ uint8_t kZigzag[64] = JPEG_ZIGZAG_ORDER;

__global__ void __launch_bounds__(kThreads)
    symbol_streams_kernel(const int16_t* __restrict__ y, const int16_t* __restrict__ cb,
                          const int16_t* __restrict__ cr, int n_blocks, int s420, int n_groups,
                          const int32_t* __restrict__ prev_dc, const int32_t* __restrict__ luts,
                          int32_t* __restrict__ codes, int32_t* __restrict__ lens) {
  __shared__ int32_t lut_s[SYM_LUT_WORDS];
  __shared__ uint8_t zigzag_s[64];
  __shared__ int32_t codes_s[kThreads * SYM_SLOTS];
  __shared__ int32_t lens_s[kThreads * SYM_SLOTS];
  for (int j = threadIdx.x; j < SYM_LUT_WORDS; j += kThreads) lut_s[j] = luts[j];
  zigzag_s[threadIdx.x] = kZigzag[threadIdx.x];
  __syncthreads();
  const int b0 = blockIdx.x * kThreads;
  const int b = b0 + threadIdx.x;
  if (b < n_blocks) {
    symbol_block_at(b, n_blocks, s420 != 0, n_groups, y, cb, cr, prev_dc, lut_s, zigzag_s,
                    codes_s + threadIdx.x * SYM_SLOTS, lens_s + threadIdx.x * SYM_SLOTS);
  }
  __syncthreads();
  const int rows = min(kThreads, n_blocks - b0);
  const size_t out0 = (size_t)b0 * SYM_SLOTS;
  for (int j = threadIdx.x; j < rows * SYM_SLOTS; j += kThreads) {
    codes[out0 + j] = codes_s[j];
    lens[out0 + j] = lens_s[j];
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// y, cb, cr: the quantized natural-order blocks, (n, 64) int16 each (4n
// luma blocks for 4:2:0); n_groups restart groups of equal size, or
// prev_dc ((3,) int32 on the device) for the carried stream, with n_groups
// 1; luts: the packed table (SYM_LUT_WORDS int32); codes, lens: (B, 65)
// int32, B = 3n or 6n blocks in MCU order.
extern "C" int symbol_streams_launch(const int16_t* y, const int16_t* cb, const int16_t* cr,
                                     int n_mcu, int s420, int n_groups, const int32_t* prev_dc,
                                     const int32_t* luts, int32_t* codes, int32_t* lens,
                                     void* stream) {
  const int n_blocks = n_mcu * (s420 ? 6 : 3);
  const int ctas = (n_blocks + kThreads - 1) / kThreads;
  symbol_streams_kernel<<<ctas, kThreads, 0, (cudaStream_t)stream>>>(
      y, cb, cr, n_blocks, s420, n_groups, prev_dc, luts, codes, lens);
  return (int)cudaGetLastError();
}
