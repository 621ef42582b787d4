// Phase-1 JPEG entropy pack on Hopper.
//
// Replaces image_stitch_tpu/ops/pallas_kernels.py::_pack_kernel (reached
// through pack_blocks_aligned_pallas). One thread per 8x8 block runs the
// 33-pair chain of pack.cuh::pack_block; its n_aw accumulator words stay in
// the thread's registers or local memory for the whole chain, so device
// memory sees the symbol stream once and the packed words once.
//
// What bounds it on the H100: reading the (nb, n_sym) codes and lengths,
// 2 * 65 * 4 = 520 B per block (51 MB for one 256 x 8192 4:4:4 band of
// 98,304 blocks), against n_aw * 4 = 56 B written per block at q85. The
// arithmetic is a few dozen integer operations per pair.
//
// Layout: the output is (nb, n_aw), block-major. The merge kernel (merge.cu)
// reads it one block per thread, so each thread finds its words contiguous;
// the TPU kernel wrote (n_aw, nb) because its vector lanes ran over blocks.
// The inputs stay (nb, n_sym) as the symbol stage produces them: thread b
// walks its own row, so one warp's loads are strided by 260 B and lean on
// L1 for the seven neighbouring words of each 32 B sector. A coalesced
// (n_sym, nb) input, or one warp per block, is work for a later change.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pack.cuh"

namespace {

__global__ void pack_blocks_aligned_kernel(const int32_t* __restrict__ codes,
                                           const int32_t* __restrict__ lens,
                                           const int32_t* __restrict__ starts,
                                           int32_t* __restrict__ out, int nb,
                                           int n_sym, int n_aw) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const size_t row = (size_t)b * (size_t)n_sym;
  pack_block(codes + row, lens + row, starts[b], n_sym, n_aw,
             out + (size_t)b * (size_t)n_aw);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int pack_blocks_aligned_launch(const int32_t* codes,
                                          const int32_t* lens,
                                          const int32_t* starts, int32_t* out,
                                          int nb, int n_sym, int n_aw,
                                          void* stream) {
  const int threads = 256;
  const int blocks = (nb + threads - 1) / threads;
  pack_blocks_aligned_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      codes, lens, starts, out, nb, n_sym, n_aw);
  return (int)cudaGetLastError();
}
