// JPEG entropy pack and merge in one Hopper kernel.
//
// Replaces image_stitch_tpu/ops/pallas_kernels.py::_pack_kernel (reached
// through pack_blocks_aligned_pallas) together with the merge that follows
// it, image_stitch_tpu/ops/jpeg_entropy_device.py::_merge_aligned_hybrid.
// The TPU wrote each block's pre-aligned words to an (n_aw, nb) buffer in
// HBM, because its vector lanes ran over blocks and its merge was a second
// program; here nothing else reads those words, so they never leave the SM.
//
// One warp per 8x8 block, kWarps blocks per CTA. Lane p takes symbol pair p
// (slots 2p and 2p + 1), so one warp's loads of codes and lengths are
// consecutive words. A warp inclusive scan of the pairs' lengths, started
// at (start & 31), gives each pair the end bit of the serial chain; past 32
// pairs (65 slots make 33) the loop runs again from the last lane's sum.
// Each pair ORs its three clipped words (pack_merge.cuh::pair_words) into
// the warp's n_aw-word staging row in shared memory. After __syncwarp, lane
// c adds staged word c, if it is not zero, into dense[(start >> 5) + c]:
// consecutive lanes hit consecutive addresses.
//
// The global update is an atomicAdd, as the plain version's index_add_:
// blocks' bit ranges are disjoint, so ADD equals OR, and where an
// over-budget block's clipped words do overlap the next block the sum is
// still the plain version's, modulo 2^32, in any order.
//
// What bounds it on the H100: reading the (nb, n_sym) codes and lengths,
// 2 * 65 * 4 = 520 B per block (51.1 MB for one 256 x 8192 4:4:4 band of
// 98,304 blocks), against about 0.5 MB of dense words. The dense stream is
// zeroed by the wrapper (one memset); no (nb, n_aw) buffer and no second
// launch remain.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pack_merge.cuh"

namespace {

constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
    pack_merge_kernel(const int32_t* __restrict__ codes,
                      const int32_t* __restrict__ lens,
                      const int32_t* __restrict__ starts,
                      uint32_t* __restrict__ dense, int nb, int n_sym, int n_aw,
                      int n_words) {
  __shared__ uint32_t stage[kWarps][PACK_MAX_AW];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= nb) return;  // b is the same for the whole warp
  uint32_t* row = stage[warp];
  row[lane] = 0u;
  const int32_t start = starts[b];
  const size_t base = (size_t)b * (size_t)n_sym;
  const int n_pairs = (n_sym + 1) >> 1;
  int off = start & 31;
  __syncwarp();
  for (int p0 = 0; p0 < n_pairs; p0 += 32) {
    const int p = p0 + lane;
    const int s = 2 * p;
    uint32_t c1 = 0u, c2 = 0u;
    int l1 = 0, l2 = 0;
    if (p < n_pairs) {
      c1 = (uint32_t)codes[base + s];
      l1 = lens[base + s];
      // An odd slot count pads with one zero-length slot, as the reference.
      if (s + 1 < n_sym) {
        c2 = (uint32_t)codes[base + s + 1];
        l2 = lens[base + s + 1];
      }
    }
    int incl = l1 + l2;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += up;
    }
    if (p < n_pairs) {
      const PairWords pw = pair_words(c1, c2, l2, off + incl, n_aw);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        if (pw.val[k] != 0u) atomicOr(row + pw.idx[k], pw.val[k]);
      }
    }
    off += __shfl_sync(kFull, incl, 31);
  }
  __syncwarp();
  if (lane < n_aw) {
    const uint32_t v = row[lane];
    const int idx = dense_index(start, lane, n_words);
    // A zero word changes nothing; skipping it saves the atomic.
    if (v != 0u && idx >= 0) atomicAdd(dense + idx, v);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// `dense` must hold n_words zeroed words; n_aw <= PACK_MAX_AW.
extern "C" int pack_merge_launch(const int32_t* codes, const int32_t* lens,
                                 const int32_t* starts, int32_t* dense, int nb,
                                 int n_sym, int n_aw, int n_words,
                                 void* stream) {
  const int blocks = (nb + kWarps - 1) / kWarps;
  pack_merge_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      codes, lens, starts, (uint32_t*)dense, nb, n_sym, n_aw, n_words);
  return (int)cudaGetLastError();
}
