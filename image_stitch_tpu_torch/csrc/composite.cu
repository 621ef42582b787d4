// Positioned alpha compositing on Hopper.
//
// Replaces the compositor program of image_stitch_tpu/ops/composite_device.py:
// _composite_run_trace, a lax.scan of _alpha_over_window_u8 over z-ordered
// segments padded to pow2 size buckets, each step a dynamic_update_slice of
// its window into a band canvas padded and bucketed for the XLA compile
// cache. Here one thread owns one output pixel: it starts from the
// background and loops over the S segments in z order, blending where the
// pixel lies inside one (composite.cuh::composite_pixel). Alpha-over touches
// only its own pixel, so this loop and the scan give the same band. No
// padding, bucketing or per-run program is left: the segments' real pixels
// arrive packed in one buffer with a (S, 6) int64 meta table.
//
// What bounds it on the H100: S containment tests per output pixel (four
// meta loads, broadcast from L1, and a few compares each), S * H * W in all,
// about 1e8 for a 256 x 8192 band under 50 segments; plus reading the
// sources, which grows with the real segment area, and one 4-byte store per
// pixel. Ties are rare; a thread that finds one adds its count with one
// atomicAdd. Binning segments by tile, so that a pixel tests only the
// segments that can cover it, is work for a later change.
#include <cuda_runtime.h>
#include <stdint.h>

#include "composite.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    composite_segments_kernel(const int64_t* __restrict__ metas, int s_count,
                              const uint8_t* __restrict__ srcs, uint32_t bg_packed,
                              uint8_t* __restrict__ out, int h, int w, int32_t* __restrict__ ties) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= (long long)h * w) return;
  const uint8_t bg[4] = {(uint8_t)bg_packed, (uint8_t)(bg_packed >> 8), (uint8_t)(bg_packed >> 16),
                         (uint8_t)(bg_packed >> 24)};
  uint8_t px[4];
  const int t = composite_pixel((int)(p / w), (int)(p % w), metas, s_count, srcs, bg, px);
  *(uint32_t*)(out + 4 * p) =
      (uint32_t)px[0] | ((uint32_t)px[1] << 8) | ((uint32_t)px[2] << 16) | ((uint32_t)px[3] << 24);
  if (t) atomicAdd(ties, t);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// metas: (s_count, 6) int64 (composite.cuh META_*); srcs: the packed
// segment pixels; bg_packed: the background RGBA, R in the low byte; out:
// (h, w, 4) uint8, 4-byte aligned; ties: one zeroed int32.
extern "C" int composite_segments_launch(const int64_t* metas, int s_count, const uint8_t* srcs,
                                         uint32_t bg_packed, uint8_t* out, int h, int w,
                                         int32_t* ties, void* stream) {
  const long long n = (long long)h * w;
  const long long blocks = (n + kThreads - 1) / kThreads;
  composite_segments_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      metas, s_count, srcs, bg_packed, out, h, w, ties);
  return (int)cudaGetLastError();
}
