// PNG filter select on Hopper.
//
// Replaces image_stitch_tpu/ops/pallas_kernels.py::_filter_kernel (reached
// through filter_select_pallas), and with it the band's byte view that
// ops/device.py::_u8_band_to_bytes / _u16_band_to_bytes built first: the
// kernel reads the band in its native type (filter.cuh, swap).
//
// Work split: one thread block per row. Pass 1: the threads stride over the
// row's n bytes, each summing the five |signed residue| scores of its bytes
// in int32; warp shuffles and shared memory reduce them, and one thread
// picks the first minimum (filter.cuh::filter_choose) and writes the type.
// Pass 2: the same threads write the winner's bytes. `up` is row r - 1 read
// in place, or the carry row for row 0; the TPU kernel instead built a
// shifted copy of the band (filter_select_pallas's `up`) and tiled rows by
// 8 with lanes padded to 128, which Hopper does not need.
//
// What bounds it on the H100: device memory bandwidth. Each row reads its
// raw bytes and the row above and writes its filtered bytes, about 3n bytes:
// at the png_out shape (256 rows, n = 32,768 for 8-bit and 65,536 for
// 16-bit) about 25 MB (8-bit) or 50 MB (16-bit) per band, at least 7.5 or
// 15 us at 3.35 TB/s. Neighbouring threads read neighbouring bytes, so each
// warp's byte loads fall in one 32 B sector; the left, upleft and pass-2
// re-reads hit L1/L2, and the row above is the previous block's raw row,
// mostly still in L2. The arithmetic is a few dozen integer operations per
// byte. Byte loads rather than 16 B vector loads keep this first version
// simple; that and a wider tile per block are work for a later change.
#include <cuda_runtime.h>
#include <stdint.h>

#include "filter.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
    filter_select_kernel(const uint8_t* __restrict__ band, const uint8_t* __restrict__ prev,
                         uint8_t* __restrict__ filtered, uint8_t* __restrict__ types, int n,
                         int bpp, int swap) {
  __shared__ int partial[FILTER_COUNT][kWarps];
  __shared__ int chosen;
  const int r = blockIdx.x;
  const uint8_t* raw = band + (size_t)r * (size_t)n;
  const uint8_t* up = r ? raw - n : prev;
  const int up_swap = r ? swap : 0;

  int sums[FILTER_COUNT] = {0, 0, 0, 0, 0};
  for (int i = threadIdx.x; i < n; i += kThreads) {
    filter_accumulate(filter_pixel(raw, swap, up, up_swap, i, bpp), sums);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < FILTER_COUNT; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sums[k] += __shfl_down_sync(0xffffffffu, sums[k], off);
    if (lane == 0) partial[k][warp] = sums[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int total[FILTER_COUNT];
#pragma unroll
    for (int k = 0; k < FILTER_COUNT; ++k) {
      total[k] = 0;
      for (int w = 0; w < kWarps; ++w) total[k] += partial[k][w];
    }
    chosen = filter_choose(total);
    types[r] = (uint8_t)chosen;
  }
  __syncthreads();

  const int choice = chosen;
  uint8_t* out = filtered + (size_t)r * (size_t)n;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const FilterPixel p = filter_pixel(raw, swap, up, up_swap, i, bpp);
    out[i] = (uint8_t)filter_residue(choice, p.x, p.a, p.b, p.c);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// band: h rows of n bytes (16-bit samples little-endian when swap = 1);
// prev: the n-byte carry row in PNG byte order; filtered: h * n bytes;
// types: h bytes.
extern "C" int filter_select_launch(const uint8_t* band, const uint8_t* prev, uint8_t* filtered,
                                    uint8_t* types, int h, int n, int bpp, int swap,
                                    void* stream) {
  filter_select_kernel<<<h, kThreads, 0, (cudaStream_t)stream>>>(band, prev, filtered, types, n,
                                                                 bpp, swap);
  return (int)cudaGetLastError();
}
