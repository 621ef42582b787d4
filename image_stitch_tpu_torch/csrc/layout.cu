// JPEG encode: the layout of a band's packed stream on Hopper, one launch.
//
// Replaces the layout of the XLA programs
// image_stitch_tpu/ops/jpeg_entropy_device.py:1076
// jpeg_pack_groups_from_blocks_trace (restart groups laid out densely) and
// :372 entropy_pack_trace_v2 (the carried stream): sums of the lengths per
// block and per group, ceil(bits / 32) per group, two exclusive cumulative
// sums and a maximum; in torch about ten launches per band. It takes the
// blocks' bit counts from symbol_streams and gives pack_merge its start
// bits, and the host the groups' bit counts, the largest block and, for the
// carried stream, the total and the next band's first bit, all left on the
// card: nothing is read back here.
//
// A scan over up to a few hundred thousand small integers: 0.4 MB in, 0.4 MB
// out, so launch latency bounds it, and the design is whatever needs one
// launch and no zeroing. One CTA per chunk of LAYOUT_CHUNK blocks
// (layout.cuh), chunks never crossing a group:
// - the CTA scans its chunk: four blocks per thread, a __shfl_up_sync scan
//   per warp, the warps' sums combined through shared memory;
// - it publishes the chunk's aggregate (64-bit sum, maximum) and a flag,
//   then reads the aggregates of every chunk before it (a thread per earlier
//   group, a thread per earlier chunk of its own group) and reduces them to
//   its base. One group of 98,304 blocks is 96 CTAs side by side, 32 groups
//   of 3,072 are 96 too: no CTA loops over a long group;
// - the last chunk of a group writes group_bits; the last chunk of the band
//   writes the maximum and the totals.
//
// Waiting on other CTAs is safe because a CTA takes its chunk number from a
// ticket counter when it starts: it only ever waits for CTAs that started
// before it. Counter and flags live in a scratch buffer that is zeroed once,
// when it is made, and never again: `done` holds the tickets of all finished
// launches, so ticket - done is the chunk number, and a flag is set by
// writing done + 1, a value no earlier launch wrote. Launches that share a
// scratch buffer must run one after another (one stream).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "layout.cuh"

namespace {

constexpr int kThreads = LAYOUT_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Words of the scratch buffer for `cap` chunks: counter, done, then the
// aggregates (int64 sum, uint32 flag, int32 maximum per chunk).
constexpr int kCounter = 0, kDone = 1, kAgg = 2;

__device__ __forceinline__ uint32_t load_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

struct Totals {
  uint32_t words;
  long long bits;
  int32_t max;
};

// Sum of words and bits and maximum of max over the CTA; every thread gets
// the result. `s` is reused: the caller syncs before the next call.
__device__ __forceinline__ Totals cta_totals(Totals t, Totals* s) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    t.words += __shfl_xor_sync(kFull, t.words, d);
    t.bits += __shfl_xor_sync(kFull, t.bits, d);
    t.max = max(t.max, __shfl_xor_sync(kFull, t.max, d));
  }
  if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = t;
  __syncthreads();
  Totals out = {0u, 0ll, INT_MIN};
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    out.words += s[w].words;
    out.bits += s[w].bits;
    out.max = max(out.max, s[w].max);
  }
  return out;
}

__global__ void __launch_bounds__(kThreads)
    group_layout_kernel(const int32_t* __restrict__ block_bits, int n_blocks, int n_groups,
                        int chunks_per_group, const long long* __restrict__ bit_base,
                        uint32_t* scratch, int cap, int32_t* __restrict__ starts,
                        int32_t* __restrict__ group_bits, int32_t* __restrict__ max_bits,
                        long long* __restrict__ totals) {
  __shared__ uint32_t s_k, s_tag;
  __shared__ uint32_t s_scan[kWarps];
  __shared__ Totals s_tot[kWarps];
  long long* agg = reinterpret_cast<long long*>(scratch + kAgg);
  uint32_t* flag = scratch + kAgg + 2 * cap;
  int32_t* amax = reinterpret_cast<int32_t*>(flag + cap);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_chunks = n_groups * chunks_per_group;
  if (tid == 0) {
    const uint32_t done = load_acquire(scratch + kDone);
    s_k = atomicAdd(scratch + kCounter, 1u) - done;
    s_tag = done + 1u;
  }
  __syncthreads();
  const int k = (int)s_k;
  const uint32_t tag = s_tag;
  const LayoutChunk ck = layout_chunk(k, n_blocks, n_groups, chunks_per_group);

  // The chunk's own scan: LAYOUT_ITEMS consecutive blocks per thread.
  int32_t v[LAYOUT_ITEMS];
  uint32_t tsum = 0u;
  Totals mine = {0u, 0ll, INT_MIN};
#pragma unroll
  for (int i = 0; i < LAYOUT_ITEMS; ++i) {
    const int idx = tid * LAYOUT_ITEMS + i;
    v[i] = 0;
    if (idx < ck.count) {
      v[i] = block_bits[ck.first + idx];
      mine.max = max(mine.max, v[i]);
    }
    tsum += (uint32_t)v[i];
    mine.bits += v[i];
  }
  uint32_t incl = tsum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t up = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) s_scan[warp] = incl;
  const Totals chunk = cta_totals(mine, s_tot);  // syncs after s_scan is written
  uint32_t excl = incl - tsum;
  for (int w = 0; w < warp; ++w) excl += s_scan[w];
  if (tid == 0) {
    agg[k] = chunk.bits;
    amax[k] = chunk.max;
    store_release(flag + k, tag);
  }

  // The chunks before this one: a thread per earlier group sums the group's
  // chunks into its words; a thread per earlier chunk of this group adds its
  // bits. Each waits for the flags of the chunks it reads.
  Totals before = {0u, 0ll, INT_MIN};
  for (int h = tid; h < ck.group; h += kThreads) {
    long long group_sum = 0;
    for (int c = 0; c < chunks_per_group; ++c) {
      const int j = h * chunks_per_group + c;
      while (load_acquire(flag + j) != tag) {
      }
      group_sum += __ldcg(agg + j);
      before.max = max(before.max, __ldcg(amax + j));
    }
    before.words += (uint32_t)layout_used_words(group_sum);
  }
  for (int c = tid; c < ck.index; c += kThreads) {
    const int j = ck.group * chunks_per_group + c;
    while (load_acquire(flag + j) != tag) {
    }
    before.bits += __ldcg(agg + j);
    before.max = max(before.max, __ldcg(amax + j));
  }
  __syncthreads();  // s_tot is read by every thread above
  before = cta_totals(before, s_tot);

  const long long base_bit = bit_base != nullptr ? *bit_base : 0ll;
  uint32_t at = layout_chunk_base(before.words, before.bits, base_bit) + excl;
#pragma unroll
  for (int i = 0; i < LAYOUT_ITEMS; ++i) {
    const int idx = tid * LAYOUT_ITEMS + i;
    if (idx < ck.count) starts[ck.first + idx] = (int32_t)at;
    at += (uint32_t)v[i];
  }
  if (tid == 0) {
    const long long group_sum = before.bits + chunk.bits;
    if (ck.index == chunks_per_group - 1) group_bits[ck.group] = (int32_t)group_sum;
    if (k == n_chunks - 1) {
      *max_bits = max(before.max, chunk.max);
      if (totals != nullptr) {
        totals[0] = base_bit + group_sum;
        totals[1] = (base_bit + group_sum) & 7ll;
      }
      // Every chunk's flag was seen: no CTA of this launch reads `done` any
      // more, and the next launch on the stream starts after this one ends.
      store_release(scratch + kDone, tag - 1u + (uint32_t)n_chunks);
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue when the scratch buffer is too small.
// block_bits: (n_blocks,) int32, n_blocks > 0 a multiple of n_groups;
// bit_base: the carried stream's first bit, one int64 on the device (with
// n_groups 1), or null for restart groups; scratch: 2 + 4 * cap int32 words,
// 8 B aligned, zeroed when made and from then on written by these launches
// only, all of them on one stream; cap: at least n_groups *
// ceil(n_blocks / n_groups / LAYOUT_CHUNK) chunks. Out: starts (n_blocks,)
// int32; group_bits (n_groups,) int32; max_bits () int32; totals (2,) int64,
// the total bits with bit_base and the same modulo 8 (null with a null
// bit_base).
extern "C" int group_layout_launch(const int32_t* block_bits, int n_blocks, int n_groups,
                                   const int64_t* bit_base, int32_t* scratch, int cap,
                                   int32_t* starts, int32_t* group_bits, int32_t* max_bits,
                                   int64_t* totals, void* stream) {
  const int group_len = n_blocks / n_groups;
  const int chunks_per_group = (group_len + LAYOUT_CHUNK - 1) / LAYOUT_CHUNK;
  const long long n_chunks = (long long)n_groups * chunks_per_group;
  if (n_chunks > cap) return (int)cudaErrorInvalidValue;
  group_layout_kernel<<<(int)n_chunks, kThreads, 0, (cudaStream_t)stream>>>(
      block_bits, n_blocks, n_groups, chunks_per_group, (const long long*)bit_base,
      (uint32_t*)scratch, cap, starts, group_bits, max_bits, (long long*)totals);
  return (int)cudaGetLastError();
}
