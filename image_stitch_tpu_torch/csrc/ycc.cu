// JPEG decode: upsampling and colour of every tile of a band on Hopper, in
// one launch, written straight into the output band.
//
// Replaces the XLA ops of image_stitch_tpu/codecs/jpeg/device_decoder.py:57
// _decode_band_trace after the IDCT: the window crop, upsample_plane_x
// (ops/jpeg_idct_device.py:437), ycc_to_rgb_planes_x (:457), the alpha
// column and the concatenation of the tiles of a band (core.py:716-724),
// which the JAX package runs once per tile. Here a tile is an entry of a
// table (ycc.cuh YCC_TILE_*): its three components' windows as offsets into
// the band's plane buffer, its first column x0 in the band and its width.
// Each tile's pixels go to the band's columns [x0, x0 + w) with the band's
// row stride, so the band is assembled by the writes themselves.
//
// A thread makes an octet, eight neighbouring pixels of a row (ycc.cuh
// ycc_octet): the luma is one 8 B load; for fancy upsampling the six chroma
// columns the octet reads are one 4 B load and two bytes a row, and for h2v2
// their six column sums are taken once (one pixel at a time took two per
// pixel, each of a pair again); the eight RGBA words leave in two 16 B
// stores where the tile's octets lie at 16 B boundaries of the band
// (YCC_VARIANT_VEC16: x0 and the band's width multiples of 4), else in
// eight 4 B stores (YCC_VARIANT_WORDS). The ragged octet at a tile's right
// edge goes one pixel at a time through ycc_pixel. A CTA of 64 threads
// covers 32 octets of 2 rows of one tile; the grid is (CTAs down the band,
// CTAs across the widest tile, tiles), so a CTA knows its tile and its
// place from its index alone and reaches its samples after one dependent
// load (the tile's row of the table); CTAs past a narrower tile's width
// leave at once. The body is compiled three times, for 4:2:0, for 4:4:4
// and for any sampling (ycc.cuh ycc_octet_by_layout): with the expansion
// factors constant the two common ones keep only their own upsampler.
//
// What bounds it on the H100: bytes, 4 B out per pixel against 1.5 B of
// planes in (4:2:0); the chroma reads of neighbouring threads and rows
// overlap and come from L1. It is latency, not issue, that keeps it off
// that bound: the chain table row -> samples -> store. So the CTA finds its
// tile without a load, a thread does eight pixels, and small CTAs at 64
// registers a thread keep 32 warps an SM in flight.
//
// Not fused with the IDCT: h2v2 fancy upsampling reads chroma rows and
// columns across block edges, so a fused kernel would recompute or exchange
// halos; the planes of a band (3.3 MB) stay in L2 between the two launches.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ycc.cuh"

namespace {

constexpr int kThreads = YCC_CTA_OCTETS * YCC_CTA_ROWS;
// CTAs an SM that the compiler must leave room for: 16 of 64 threads, so at
// most 64 registers a thread (it takes 75 to 89 unasked, three CTAs of 256
// an SM, and the chain of loads then sets the time).
constexpr int kMinCtas = 16;

__global__ void __launch_bounds__(kThreads, kMinCtas)
    ycc_rgba_batch_kernel(const uint8_t* __restrict__ planes, const int32_t* __restrict__ tiles,
                          uint8_t* __restrict__ out, long long out_stride, int h) {
  const int32_t* tile = tiles + (size_t)blockIdx.z * YCC_TILE_COLS;
  const int w = tile[YCC_TILE_W];
  const int o = blockIdx.y * YCC_CTA_OCTETS + (threadIdx.x & (YCC_CTA_OCTETS - 1));
  const int y = blockIdx.x * YCC_CTA_ROWS + threadIdx.x / YCC_CTA_OCTETS;
  const int x = 8 * o;
  if (x >= w || y >= h) return;
  const int n_comp = tile[YCC_TILE_NCOMP];
  YccComp comps[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) comps[i] = ycc_tile_comp(planes, tile, i < n_comp ? i : 0);
  const int n = w - x < 8 ? w - x : 8;
  uint32_t px[8];
  ycc_octet_by_layout(comps, n_comp, y, x, n, px);
  uint8_t* dst = out + (size_t)y * (size_t)out_stride + (size_t)(tile[YCC_TILE_X0] + x) * 4;
  if (n == 8 && tile[YCC_TILE_VARIANT] == YCC_VARIANT_VEC16) {
    reinterpret_cast<uint4*>(dst)[0] = make_uint4(px[0], px[1], px[2], px[3]);
    reinterpret_cast<uint4*>(dst)[1] = make_uint4(px[4], px[5], px[6], px[7]);
  } else {
    for (int i = 0; i < n; ++i) reinterpret_cast<uint32_t*>(dst)[i] = px[i];
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// planes: the band's plane buffer; tiles: (n_tiles, YCC_TILE_COLS) int32,
// max_w the widest tile's columns; out: the band of h rows, out_stride
// bytes a row, 4 B aligned (16 B aligned, and out_stride a multiple of 16,
// for a tile of YCC_VARIANT_VEC16). All on the device.
extern "C" int ycc_rgba_batch_launch(const uint8_t* planes, const int32_t* tiles, int n_tiles,
                                     int max_w, uint8_t* out, long long out_stride, int h,
                                     void* stream) {
  const int octets = (max_w + 7) / 8;
  const dim3 grid((h + YCC_CTA_ROWS - 1) / YCC_CTA_ROWS,
                  (octets + YCC_CTA_OCTETS - 1) / YCC_CTA_OCTETS, n_tiles);
  ycc_rgba_batch_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(planes, tiles, out,
                                                                     out_stride, h);
  return (int)cudaGetLastError();
}
