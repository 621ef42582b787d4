// PNG filter select on Hopper.
//
// Replaces image_stitch_tpu/ops/pallas_kernels.py::_filter_kernel (reached
// through filter_select_pallas), and with it the band's byte view that
// ops/device.py::_u8_band_to_bytes / _u16_band_to_bytes built first: the
// kernels read the band in its native type (filter.cuh, swap).
//
// What bounds it: instruction issue. Its bytes bound is 2n a row (the raw
// row read, the filtered row written; the row above is the previous
// block's raw row, mostly in L2), 5 us for a 256 x 32,768 B band, and it
// runs at about a third of that (PERF.md). Scoring five filters byte by
// byte costs 70-90 integer instructions a byte (the byte kernel below,
// the first version, took ten times its bound); the word kernel's design
// is about cutting that count:
// - one block of 512 threads per row, two blocks per SM, so that a band's
//   256 rows run in one wave on 132 SMs;
// - each thread owns chunks of 16 B (four words of four byte lanes), read
//   once with one 16 B load of raw and one of up (4 B loads when rows are
//   not 16 B aligned); `left` of lane k in word j is lane k of word
//   j - bpp / 4, so the previous chunk's last one or two words come from
//   the neighbouring lane by __shfl_up_sync (lane 0 reads them);
// - the five candidates and their scores are SIMD-in-a-word operations
//   (filter.cuh filter_word_scores: __vsub4, __vhaddu4, a Paeth of byte
//   compares, and each residue's |signed| lanes summed into its score by
//   one vabsdiff4 with accumulate);
// - the block reduces the five sums (__reduce_add_sync, shared memory),
//   picks the first minimum, and writes only the chosen residue with 16 B
//   stores, from the kHeld chunks per thread it keeps in registers (the
//   whole of an RGBA8 row of 32,768 B); chunks past those, as in the second
//   half of an RGBA16 row, are read again, from L2.
// The word kernel takes bpp 4 and 8 with rows of whole words, every call
// the encoder makes; any other bpp, rows of n % 4 != 0 B, or a band or
// carry row that is not 4 B aligned take the byte kernel
// (filter_bytes_kernel): a dispatch on shape, chosen by the wrapper
// (ops/kernels.py filter_variant), not a fallback.
//
// SASS (image_stitch_tpu_torch/sass_report.py, nvcc 12.8 for sm_90a): the
// word kernel's pass-1 loop over one 16 B chunk (bpp 4, 16 B loads) is 283
// instructions, about 18 a byte, where the byte kernel's pass-1 loop takes
// 70 a byte; 64 registers and 52 B of spills. What is left between it and
// the bytes bound: its rows load, score, reduce and store in lockstep in
// one wave, so loads and arithmetic of different rows barely overlap.
#include <cuda_runtime.h>
#include <stdint.h>

#include "filter.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// 16 B chunks per thread kept in registers between the two passes.
constexpr int kHeld = 4;
constexpr unsigned kFull = 0xffffffffu;

// Variants; ops/kernels.py FILTER_VARIANTS names them.
enum {
  VARIANT_BYTES = 0,
  VARIANT_WORD4 = 1,        // bpp 4, 4 B loads
  VARIANT_WORD4_VEC16 = 2,  // bpp 4, 16 B loads (n % 16 == 0, 16 B aligned)
  VARIANT_WORD8 = 3,
  VARIANT_WORD8_VEC16 = 4,
};

__global__ void __launch_bounds__(kThreads)
    filter_bytes_kernel(const uint8_t* __restrict__ band, const uint8_t* __restrict__ prev,
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
    for (int off = 16; off > 0; off >>= 1) sums[k] += __shfl_down_sync(kFull, sums[k], off);
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

// Four words of a row in PNG byte order: words 4c .. 4c + 3, zero past nw.
struct Chunk {
  uint32_t w[4];
};

template <bool kVec>
__device__ __forceinline__ Chunk load_chunk(const uint8_t* row, int c, int nw, int swap) {
  Chunk k;
  if (kVec) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (4 * c < nw) v = reinterpret_cast<const uint4*>(row)[c];
    k.w[0] = v.x;
    k.w[1] = v.y;
    k.w[2] = v.z;
    k.w[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      k.w[i] = 4 * c + i < nw ? reinterpret_cast<const uint32_t*>(row)[4 * c + i] : 0u;
    }
  }
  if (swap) {
#pragma unroll
    for (int i = 0; i < 4; ++i) k.w[i] = filter_swap16(k.w[i]);
  }
  return k;
}

// The words bpp bytes to the left of chunk c's: the previous chunk's last
// kBw words come from the lane before (the same pass's chunk c - 1), or for
// lane 0 from memory; zeros at the row start. Every lane of the warp calls
// this together.
template <int kBw>
__device__ __forceinline__ Chunk chunk_left(const Chunk& x, const uint8_t* row, int c, int nw,
                                            int swap, int lane) {
  uint32_t p3 = __shfl_up_sync(kFull, x.w[3], 1);
  uint32_t p2 = kBw == 2 ? __shfl_up_sync(kFull, x.w[2], 1) : 0u;
  if (lane == 0) {
    const bool inside = c > 0 && 4 * c < nw;
    p3 = inside ? filter_load_word(row, 4 * c - 1, swap) : 0u;
    if (kBw == 2) p2 = inside ? filter_load_word(row, 4 * c - 2, swap) : 0u;
  }
  Chunk a;
  if (kBw == 1) {
    a.w[0] = p3;
    a.w[1] = x.w[0];
    a.w[2] = x.w[1];
    a.w[3] = x.w[2];
  } else {
    a.w[0] = p2;
    a.w[1] = p3;
    a.w[2] = x.w[0];
    a.w[3] = x.w[1];
  }
  return a;
}

template <int kBw, bool kVec>
__device__ __forceinline__ void chunk_scores(const Chunk& x, const Chunk& u, const uint8_t* raw,
                                             const uint8_t* up, int c, int nw, int swap,
                                             int up_swap, int lane, uint32_t sums[FILTER_COUNT]) {
  const Chunk a = chunk_left<kBw>(x, raw, c, nw, swap, lane);
  const Chunk ul = chunk_left<kBw>(u, up, c, nw, up_swap, lane);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (4 * c + (kVec ? 0 : i) < nw) filter_word_scores(x.w[i], a.w[i], u.w[i], ul.w[i], sums);
  }
}

template <int kBw, bool kVec>
__device__ __forceinline__ void chunk_store(const Chunk& x, const Chunk& u, const uint8_t* raw,
                                            const uint8_t* up, int c, int nw, int swap,
                                            int up_swap, int lane, int choice, uint8_t* out) {
  const Chunk a = chunk_left<kBw>(x, raw, c, nw, swap, lane);
  const Chunk ul = chunk_left<kBw>(u, up, c, nw, up_swap, lane);
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = filter_word_residue(choice, x.w[i], a.w[i], u.w[i], ul.w[i]);
  if (kVec) {
    if (4 * c < nw) reinterpret_cast<uint4*>(out)[c] = make_uint4(r[0], r[1], r[2], r[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (4 * c + i < nw) reinterpret_cast<uint32_t*>(out)[4 * c + i] = r[i];
    }
  }
}

// kBw: bpp / 4, the words between a byte and its `left`. kVec: 16 B loads
// and stores (rows and pointers 16 B aligned).
template <int kBw, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    filter_word_kernel(const uint8_t* __restrict__ band, const uint8_t* __restrict__ prev,
                       uint8_t* __restrict__ filtered, uint8_t* __restrict__ types, int n,
                       int swap) {
  __shared__ uint32_t partial[FILTER_COUNT][kWarps];
  __shared__ int chosen;
  const int r = blockIdx.x;
  const int nw = n >> 2;
  // Passes of the block over the row's chunks; the same for every thread,
  // so that all lanes meet at each shuffle.
  const int iters = ((nw + 3) / 4 + kThreads - 1) / kThreads;
  const uint8_t* raw = band + (size_t)r * (size_t)n;
  const uint8_t* up = r ? raw - n : prev;
  const int up_swap = r ? swap : 0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  Chunk hx[kHeld], hu[kHeld];
#pragma unroll
  for (int k = 0; k < kHeld; ++k) {
    if (k < iters) {
      hx[k] = load_chunk<kVec>(raw, threadIdx.x + k * kThreads, nw, swap);
      hu[k] = load_chunk<kVec>(up, threadIdx.x + k * kThreads, nw, up_swap);
    }
  }
  uint32_t sums[FILTER_COUNT] = {0u, 0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < kHeld; ++k) {
    if (k < iters) {
      chunk_scores<kBw, kVec>(hx[k], hu[k], raw, up, threadIdx.x + k * kThreads, nw, swap,
                              up_swap, lane, sums);
    }
  }
  for (int k = kHeld; k < iters; ++k) {
    const int c = threadIdx.x + k * kThreads;
    const Chunk x = load_chunk<kVec>(raw, c, nw, swap);
    const Chunk u = load_chunk<kVec>(up, c, nw, up_swap);
    chunk_scores<kBw, kVec>(x, u, raw, up, c, nw, swap, up_swap, lane, sums);
  }

#pragma unroll
  for (int k = 0; k < FILTER_COUNT; ++k) {
    const uint32_t s = __reduce_add_sync(kFull, sums[k]);
    if (lane == 0) partial[k][warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int total[FILTER_COUNT];
#pragma unroll
    for (int k = 0; k < FILTER_COUNT; ++k) {
      uint32_t t = 0;
      for (int w = 0; w < kWarps; ++w) t += partial[k][w];
      total[k] = (int)t;  // below 128 * n < 2^31
    }
    chosen = filter_choose(total);
    types[r] = (uint8_t)chosen;
  }
  __syncthreads();

  const int choice = chosen;
  uint8_t* out = filtered + (size_t)r * (size_t)n;
#pragma unroll
  for (int k = 0; k < kHeld; ++k) {
    if (k < iters) {
      chunk_store<kBw, kVec>(hx[k], hu[k], raw, up, threadIdx.x + k * kThreads, nw, swap,
                             up_swap, lane, choice, out);
    }
  }
  for (int k = kHeld; k < iters; ++k) {
    const int c = threadIdx.x + k * kThreads;
    const Chunk x = load_chunk<kVec>(raw, c, nw, swap);
    const Chunk u = load_chunk<kVec>(up, c, nw, up_swap);
    chunk_store<kBw, kVec>(x, u, raw, up, c, nw, swap, up_swap, lane, choice, out);
  }
}

}  // namespace

// Launches `variant` on `stream` and returns cudaGetLastError() (0 =
// launched), or cudaErrorInvalidValue for a variant the shape does not
// allow. band: h rows of n bytes (16-bit samples little-endian when swap =
// 1); prev: the n-byte carry row in PNG byte order; filtered: h * n bytes;
// types: h bytes.
extern "C" int filter_select_launch(const uint8_t* band, const uint8_t* prev, uint8_t* filtered,
                                    uint8_t* types, int h, int n, int bpp, int swap, int variant,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t ptrs = (uintptr_t)band | (uintptr_t)prev | (uintptr_t)filtered;
  const bool word = (variant == VARIANT_WORD4 || variant == VARIANT_WORD4_VEC16) ? bpp == 4
                    : (variant == VARIANT_WORD8 || variant == VARIANT_WORD8_VEC16) ? bpp == 8
                                                                                   : true;
  const int align = (variant == VARIANT_WORD4_VEC16 || variant == VARIANT_WORD8_VEC16) ? 16
                    : variant == VARIANT_BYTES                                         ? 1
                                                                                       : 4;
  if (!word || n % align != 0 || ptrs % align != 0) return (int)cudaErrorInvalidValue;
  switch (variant) {
    case VARIANT_BYTES:
      filter_bytes_kernel<<<h, kThreads, 0, s>>>(band, prev, filtered, types, n, bpp, swap);
      break;
    case VARIANT_WORD4:
      filter_word_kernel<1, false><<<h, kThreads, 0, s>>>(band, prev, filtered, types, n, swap);
      break;
    case VARIANT_WORD4_VEC16:
      filter_word_kernel<1, true><<<h, kThreads, 0, s>>>(band, prev, filtered, types, n, swap);
      break;
    case VARIANT_WORD8:
      filter_word_kernel<2, false><<<h, kThreads, 0, s>>>(band, prev, filtered, types, n, swap);
      break;
    case VARIANT_WORD8_VEC16:
      filter_word_kernel<2, true><<<h, kThreads, 0, s>>>(band, prev, filtered, types, n, swap);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
