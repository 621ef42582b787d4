// JPEG decode: upsampling and colour of a band window on Hopper, written
// straight into the output band.
//
// Replaces the XLA ops of image_stitch_tpu/codecs/jpeg/device_decoder.py:57
// _decode_band_trace after the IDCT: the window crop, upsample_plane_x
// (ops/jpeg_idct_device.py:437), ycc_to_rgb_planes_x (:457), the alpha
// column and the concatenation of the tiles of a band (core.py:716-724).
// Each tile's pixels go to the band's columns [x0, x0 + width) with the
// band's row stride, so the band is assembled by the writes themselves.
//
// One thread per output pixel: it reads its 1 to 4 samples of each
// component (ycc.cuh ycc_sample), converts, and stores one 4 B word; a warp
// covers 32 consecutive pixels of one row, so the stores coalesce and the
// plane reads hit the same few lines.
//
// What bounds it on the H100: bytes, 4 B out per pixel against 1.5 B of
// planes in (4:2:0). A simple kernel first; not tuned.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ycc.cuh"

namespace {

constexpr int kThreads = 256;

struct YccArgs {
  YccComp comp[3];
  int n_comp;
  uint8_t* out;
  long long out_stride;
  int x0;
  int h;
  int w;
};

__global__ void __launch_bounds__(kThreads) ycc_rgba_kernel(const YccArgs a) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= a.w || y >= a.h) return;
  const uint32_t word = ycc_pixel(a.comp, a.n_comp, y, x);
  *reinterpret_cast<uint32_t*>(a.out + (size_t)y * (size_t)a.out_stride +
                               (size_t)(a.x0 + x) * 4) = word;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// planes[i]: component i's plane; geom: n_comp rows of (stride, h_exp, v_exp,
// r0, w0l, hw, comp_w), host memory; out: the band, out_stride bytes a row,
// 4 B aligned; the tile covers its rows [0, h) and columns [x0, x0 + w).
extern "C" int ycc_rgba_launch(const uint8_t* p0, const uint8_t* p1, const uint8_t* p2,
                               const int32_t* geom, int n_comp, uint8_t* out,
                               long long out_stride, int x0, int h, int w, void* stream) {
  if (n_comp != 1 && n_comp != 3) return (int)cudaErrorInvalidValue;
  YccArgs a;
  const uint8_t* planes[3] = {p0, p1, p2};
  for (int i = 0; i < 3; ++i) {
    const int j = i < n_comp ? i : 0;
    const int32_t* g = geom + 7 * j;
    a.comp[i] = YccComp{planes[j], g[0], g[1], g[2], g[3], g[4], g[5], g[6]};
  }
  a.n_comp = n_comp;
  a.out = out;
  a.out_stride = out_stride;
  a.x0 = x0;
  a.h = h;
  a.w = w;
  const dim3 grid((w + kThreads - 1) / kThreads, h);
  ycc_rgba_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
