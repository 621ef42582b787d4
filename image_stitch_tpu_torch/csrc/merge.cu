// Phase-2 JPEG entropy merge on Hopper.
//
// Replaces image_stitch_tpu/ops/jpeg_entropy_device.py::_merge_aligned_hybrid
// (one coverer gather per output word plus a sorted scatter-add of starter
// words), the merge that jpeg_pack_groups_from_blocks_trace runs after the
// Pallas pack kernel. One thread per block atomicOr-s its n_aw pre-aligned
// words into dense[(start >> 5) + c]. Bit ranges of different blocks are
// disjoint, so the result does not depend on the order of the atomics and is
// deterministic; there is no per-word overlap bound to check.
//
// What bounds it on the H100: reading the (nb, n_aw) packed words (56 B per
// block at q85) and the atomics on the dense stream. Neighbouring blocks
// share at most their boundary words, so atomics rarely collide; zero words
// (past a block's end) are skipped. The TPU needed the gather form because
// its scatters serialise; an atomic OR per word is Hopper's native form.
#include <cuda_runtime.h>
#include <stdint.h>

#include "merge.cuh"

namespace {

__global__ void merge_or_kernel(const int32_t* __restrict__ local,
                                const int32_t* __restrict__ starts,
                                uint32_t* __restrict__ dense, int nb, int n_aw,
                                int n_words) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  merge_block(local + (size_t)b * (size_t)n_aw, starts[b], n_aw, n_words,
              dense);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// `dense` must hold n_words zeroed words.
extern "C" int merge_or_launch(const int32_t* local, const int32_t* starts,
                               int32_t* dense, int nb, int n_aw, int n_words,
                               void* stream) {
  const int threads = 256;
  const int blocks = (nb + threads - 1) / threads;
  merge_or_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      local, starts, (uint32_t*)dense, nb, n_aw, n_words);
  return (int)cudaGetLastError();
}
