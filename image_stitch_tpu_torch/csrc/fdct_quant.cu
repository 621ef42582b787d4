// JPEG encode: colour conversion, forward DCT and quantization of a band on
// Hopper.
//
// Replaces the XLA program of image_stitch_tpu/ops/device.py:204
// jpeg_quantize_trace and :224 jpeg_quantize_420_trace
// (ops/jpeg_dct.py band_to_blocks_islow and _420): integer YCbCr planes,
// the two butterfly passes over strided views of the planes, the quantizer
// broadcast over the band and the block relayout, each a pass over device
// memory. Here one thread computes one block of one component from the
// pixels to its 64 quantized coefficients in registers (fdct_quant.cuh), so
// the band is read once and the blocks written once.
//
// The band is read with its own pixel stride (3 B for an uploaded host
// band, 4 B for a decoded or blended RGBA band on the card), so no channel
// slice is copied first. blockIdx.y is the component; its blocks come in the
// encoder's orders (strip-major for 4:4:4; TL, TR, BL, BR per MCU for 4:2:0
// luma).
//
// What bounds it on the H100: bytes in principle, 3-4 B a pixel in and
// 6 B (4:4:4) or 3 B (4:2:0) of coefficients out; but a thread's 64
// samples are 8 rows of 8 pixels, so a warp's loads touch 8 rows at a time
// and the 128 B stores of neighbouring threads interleave. A simple kernel
// first; not tuned.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fdct_quant.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    fdct_quant_kernel(const uint8_t* __restrict__ band, int w, int ch, const int32_t* lq,
                      const int32_t* cq, int s420, int n_luma, int n_chroma,
                      int16_t* __restrict__ y_out, int16_t* __restrict__ cb_out,
                      int16_t* __restrict__ cr_out) {
  __shared__ int32_t q_s[64];
  const int comp = blockIdx.y;
  if (threadIdx.x < 64) q_s[threadIdx.x] = (comp == 0 ? lq : cq)[threadIdx.x];
  __syncthreads();
  const int n = comp == 0 ? n_luma : n_chroma;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  int y0, x0;
  fdct_block_origin(i, comp, w, s420 != 0, &y0, &x0);
  int32_t s[64];
  fdct_gather(band, w, ch, comp, y0, x0, s420 != 0 && comp != 0, s);
  int16_t* out = (comp == 0 ? y_out : (comp == 1 ? cb_out : cr_out)) + (size_t)i * 64;
  int16_t coef[64];
  fdct_quant_block(s, q_s, coef);
  // 8 stores of 16 B: the block's 128 B are 16 B aligned.
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    int4 v;
    v.x = (uint16_t)coef[8 * j] | ((uint32_t)(uint16_t)coef[8 * j + 1] << 16);
    v.y = (uint16_t)coef[8 * j + 2] | ((uint32_t)(uint16_t)coef[8 * j + 3] << 16);
    v.z = (uint16_t)coef[8 * j + 4] | ((uint32_t)(uint16_t)coef[8 * j + 5] << 16);
    v.w = (uint16_t)coef[8 * j + 6] | ((uint32_t)(uint16_t)coef[8 * j + 7] << 16);
    reinterpret_cast<int4*>(out)[j] = v;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// band: (h, w, ch) uint8, ch >= 3; h and w multiples of 8 (4:4:4) or 16
// (4:2:0); lq, cq: (64,) int32 natural-order tables; y, cb, cr: the blocks,
// (n, 64) int16 each, 16 B aligned.
extern "C" int fdct_quant_launch(const uint8_t* band, int h, int w, int ch, const int32_t* lq,
                                 const int32_t* cq, int s420, int16_t* y, int16_t* cb,
                                 int16_t* cr, void* stream) {
  const int n_luma = (h / 8) * (w / 8);
  const int n_chroma = s420 ? n_luma / 4 : n_luma;
  const dim3 grid((n_luma + kThreads - 1) / kThreads, 3);
  fdct_quant_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      band, w, ch, lq, cq, s420, n_luma, n_chroma, y, cb, cr);
  return (int)cudaGetLastError();
}
