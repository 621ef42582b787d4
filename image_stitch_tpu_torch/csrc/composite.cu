// Positioned alpha compositing on Hopper.
//
// Replaces the compositor program of image_stitch_tpu/ops/composite_device.py:
// _composite_run_trace, a lax.scan of _alpha_over_window_u8 over z-ordered
// segments padded to pow2 size buckets, each step a dynamic_update_slice of
// its window into a band canvas padded and bucketed for the XLA compile
// cache. Alpha-over touches only its own pixel, so blending each pixel
// through the segments that cover it, in z order, gives the scan's band. No
// padding, bucketing or per-run program is left: the segments' real pixels
// arrive packed in one buffer with a (S, 6) int64 meta table.
//
// What bounds it: the integer pipe. Each blended pixel costs about 100
// integer instructions (SASS below), which issue at half the float rate,
// so the kernel runs at about a fifth of its bytes bound (the band written
// once, the metas and the sources read once; PERF.md). The first version,
// one thread per pixel, spent its time elsewhere: S containment tests per
// pixel through int64 metas (1e8 for 50 segments on a 256 x 8192 band),
// a 64-bit / and % per pixel, two divisions per channel and one atomicAdd
// per thread with a tie. The design removes those:
// - one block per tile of 16 rows x 128 columns; each of a block's 256
//   threads owns a run of 8 consecutive pixels of one row, kept as packed
//   RGBA words in registers, and stores it with two 16 B stores;
// - the block culls the segments against its tile, 256 at a time: thread t
//   tests segment base + t (composite.cuh composite_cull, int32 band
//   coordinates), and a warp ballot with a __popc prefix compacts the hits
//   into a shared list in z order, since "over" does not commute. Each
//   thread then blends the list over its run (composite_apply); the running
//   RGBA stays in registers from one chunk of 256 segments to the next, so
//   any S is taken. S tests per tile replace S tests per pixel;
// - one high multiply per channel by a 32-bit reciprocal of den taken once
//   per pixel, with an exact correction (composite.cuh composite_divmod);
// - ties are summed per block and added with one atomicAdd per block that
//   has any.
//
// SASS (image_stitch_tpu_torch/sass_report.py, nvcc 12.8 for sm_90a): the
// loop over one culled segment for a thread's run of 8 pixels is 909
// instructions, about 114 a pixel with both fast paths in the count; 62
// registers, no spills.
#include <cuda_runtime.h>
#include <stdint.h>

#include "composite.cuh"

namespace {

constexpr int kRunsPerRow = COMPOSITE_TILE_W / COMPOSITE_RUN;
constexpr int kThreads = COMPOSITE_TILE_H * kRunsPerRow;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads == COMPOSITE_CHUNK, "one segment per thread in each culling step");

__global__ void __launch_bounds__(kThreads)
    composite_tile_kernel(const int64_t* __restrict__ metas, int s_count,
                          const uint8_t* __restrict__ srcs, uint32_t bg, uint8_t* __restrict__ out,
                          int h, int w, int32_t* __restrict__ ties) {
  __shared__ CompositeHit hits[COMPOSITE_CHUNK];
  __shared__ int warp_hits[kWarps];
  __shared__ int tile_ties;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tiles_x = (w + COMPOSITE_TILE_W - 1) / COMPOSITE_TILE_W;
  const int ty0 = (int)(blockIdx.x / tiles_x) * COMPOSITE_TILE_H;
  const int tx0 = (int)(blockIdx.x % tiles_x) * COMPOSITE_TILE_W;
  const int th = min(COMPOSITE_TILE_H, h - ty0);
  const int tw = min(COMPOSITE_TILE_W, w - tx0);
  const int y = ty0 + threadIdx.x / kRunsPerRow;
  const int x = tx0 + (threadIdx.x % kRunsPerRow) * COMPOSITE_RUN;
  const bool mine = y < h && x < w;

  uint32_t d[COMPOSITE_RUN];
#pragma unroll
  for (int i = 0; i < COMPOSITE_RUN; ++i) d[i] = bg;
  int my_ties = 0;
  if (threadIdx.x == 0) tile_ties = 0;
  __syncthreads();

  for (int base = 0; base < s_count; base += COMPOSITE_CHUNK) {
    const int s = base + threadIdx.x;
    CompositeHit hit;
    const bool on = s < s_count &&
                    composite_cull(metas + (size_t)s * META_COLS, srcs, ty0, tx0, th, tw, &hit);
    const unsigned mask = __ballot_sync(kFull, on);
    if (lane == 0) warp_hits[warp] = __popc(mask);
    __syncthreads();
    int before = 0;
    int count = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      const int c = warp_hits[k];
      before += k < warp ? c : 0;
      count += c;
    }
    if (on) hits[before + __popc(mask & ((1u << lane) - 1u))] = hit;
    __syncthreads();
    if (mine) {
      for (int i = 0; i < count; ++i) my_ties += composite_apply(hits[i], y, x, d);
    }
    __syncthreads();  // the list is rewritten by the next chunk
  }

  if (mine) {
    uint8_t* p = out + ((size_t)y * (size_t)w + (size_t)x) * 4;
    if (x + COMPOSITE_RUN <= w && w % 4 == 0) {
      // 16 B aligned: x is a multiple of 8 and rows of w % 4 == 0 pixels
      // are whole 16 B lines.
      reinterpret_cast<uint4*>(p)[0] = make_uint4(d[0], d[1], d[2], d[3]);
      reinterpret_cast<uint4*>(p)[1] = make_uint4(d[4], d[5], d[6], d[7]);
    } else {
#pragma unroll
      for (int i = 0; i < COMPOSITE_RUN; ++i) {
        if (x + i < w) reinterpret_cast<uint32_t*>(p)[i] = d[i];
      }
    }
  }

  const int warp_ties = (int)__reduce_add_sync(kFull, (unsigned)my_ties);
  if (lane == 0 && warp_ties) atomicAdd(&tile_ties, warp_ties);
  __syncthreads();
  if (threadIdx.x == 0 && tile_ties) atomicAdd(ties, tile_ties);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// metas: (s_count, 6) int64 (composite.cuh META_*); srcs: the packed
// segment pixels; bg_packed: the background RGBA, R in the low byte; out:
// (h, w, 4) uint8, 16-byte aligned; ties: one zeroed int32.
extern "C" int composite_segments_launch(const int64_t* metas, int s_count, const uint8_t* srcs,
                                         uint32_t bg_packed, uint8_t* out, int h, int w,
                                         int32_t* ties, void* stream) {
  const long long tiles = (long long)((w + COMPOSITE_TILE_W - 1) / COMPOSITE_TILE_W) *
                          ((h + COMPOSITE_TILE_H - 1) / COMPOSITE_TILE_H);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  composite_tile_kernel<<<(unsigned)tiles, kThreads, 0, (cudaStream_t)stream>>>(
      metas, s_count, srcs, bg_packed, out, h, w, ties);
  return (int)cudaGetLastError();
}
