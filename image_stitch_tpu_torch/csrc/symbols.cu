// JPEG encode: the Huffman symbol streams of a band on Hopper.
//
// Replaces the XLA programs image_stitch_tpu/ops/jpeg_entropy_device.py:560
// _symbol_streams_flat (restart groups) and :286 _symbol_streams (one
// carried stream): the zigzag gather, the DC differences, a cumulative max
// over the AC positions for the run lengths, and table gathers for the
// codes, each a pass over a (B, 64) array; in torch about 60 launches per
// band. It also gives what the layout needs of it: each block's bit count
// (the sum of its 65 lengths), so that the 51 MB of lengths are not read
// back to be summed, and the last DC of each component, which the carried
// stream's next band is predicted from.
//
// One warp per block of the MCU sequence, kWarps blocks per CTA, a
// grid-stride loop over the blocks so that the table is staged in shared
// memory once per CTA.
// - Lane l loads word l of the block (coefficients 2l and 2l + 1): one
//   128 B line per warp. It owns zigzag positions l and l + 32 and fetches
//   their coefficients with a shuffle from lane zigzag[p] >> 1.
// - Two ballots give the masks of the nonzero AC positions; from the masks
//   alone each lane gets the run before its position, the ZRL rule and EOB
//   (symbols.cuh symbol_prev_low, symbol_prev_high, symbol_last): no lane
//   walks the block.
// - The instruction rate bounds the kernel before bytes do (a first form
//   at 351 instructions a block ran at 0.047 ms on the H100), so a slot
//   costs as few as it can: the table is staged as one word per symbol (code | len << 16), DC
//   and AC slots run the same branch-free code (symbol_code) and differ in
//   the entry they read, the masks are 32-bit words, and the sampling is a
//   template parameter, so that the block's place in its MCU is a division
//   by a constant, and "first of its restart group" is a multiply and a
//   compare (sym_divides).
// - Lane l writes slots l and l + 32 of codes and lens straight to global
//   memory, consecutive lanes on consecutive words; lane 0 also writes slot
//   64. Nothing is staged: shared memory holds the 2.2 KB table only, so it
//   does not set the occupancy.
// - A butterfly sum of the lanes' lengths is the block's bit count.
// - The DC difference needs the previous block of the same component only
//   (symbol_block_locate): lane 0 reads that one value, no scan. The chain
//   starts from 0 at each restart group, or from prev_dc[comp] for the
//   carried stream.
//
// What bounds it on the H100: by bytes, 128 B of coefficients in and 524 B
// of codes, lengths and the bit count out per block (64.1 MB for a 256 x
// 8192 4:4:4 band of 98,304 blocks); as measured, the instruction rate
// first (above). The rows are 260 B, so a warp's 128 B stores straddle
// lines; the CTA's eight rows are contiguous, and L2 merges them.
#include <cuda_runtime.h>
#include <stdint.h>

#include "idct.cuh"
#include "symbols.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

__constant__ uint8_t kZigzag[64] = JPEG_ZIGZAG_ORDER;

template <bool kS420>
__global__ void __launch_bounds__(kThreads)
    symbol_streams_kernel(const int16_t* __restrict__ y, const int16_t* __restrict__ cb,
                          const int16_t* __restrict__ cr, int n_blocks, uint64_t group_magic,
                          const int32_t* __restrict__ prev_dc, const int32_t* __restrict__ luts,
                          int32_t* __restrict__ codes, int32_t* __restrict__ lens,
                          int32_t* __restrict__ block_bits, int32_t* __restrict__ last_dc) {
  __shared__ uint32_t comb[SYMC_WORDS];
  for (int j = threadIdx.x; j < SYMC_WORDS; j += kThreads) {
    comb[j] = symbol_combined_entry(luts, j);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // Natural index of the lane's two zigzag positions.
  const int z0 = kZigzag[lane], z1 = kZigzag[lane + 32];
  for (int b = blockIdx.x * kWarps + warp; b < n_blocks; b += gridDim.x * kWarps) {
    // The same for the whole warp.
    const SymBlock sb = symbol_block_locate(b, n_blocks, kS420, group_magic, y, cb, cr, prev_dc);
    const int t = sb.comp == 0 ? 0 : 1;
    const uint32_t w = reinterpret_cast<const uint32_t*>(sb.blk)[lane];
    const uint32_t w0 = __shfl_sync(kFull, w, z0 >> 1);
    const uint32_t w1 = __shfl_sync(kFull, w, z1 >> 1);
    int32_t v0 = (int16_t)((z0 & 1) ? (w0 >> 16) : (w0 & 0xffffu));
    const int32_t v1 = (int16_t)((z1 & 1) ? (w1 >> 16) : (w1 & 0xffffu));
    const uint32_t lo = __ballot_sync(kFull, lane != 0 && v0 != 0);
    const uint32_t hi = __ballot_sync(kFull, v1 != 0);
    if (lane == 0) {
      if (sb.last) last_dc[sb.comp] = v0;
      v0 -= sb.pred;  // zigzag position 0 is the DC: lane 0 codes the difference
    }
    const int last = symbol_last(lo, hi);
    const SymSlot s0 = symbol_code(lane == 0, lane, symbol_prev_low(lane, lo), last, v0, t, comb);
    const SymSlot s1 =
        symbol_code(false, lane + 32, symbol_prev_high(lane + 32, lo, hi), last, v1, t, comb);
    const size_t row = (size_t)b * SYM_SLOTS;
    codes[row + lane] = s0.code;
    codes[row + 32 + lane] = s1.code;
    lens[row + lane] = s0.len;
    lens[row + 32 + lane] = s1.len;
    int bits = s0.len + s1.len;
    if (lane == 0) {
      const SymSlot eob = symbol_eob(hi, t, comb);
      codes[row + 64] = eob.code;
      lens[row + 64] = eob.len;
      bits += eob.len;
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) bits += __shfl_xor_sync(kFull, bits, d);
    if (lane == 0) block_bits[b] = bits;
  }
}

// The H100's 132 SMs hold 2048 threads each: this many CTAs fill the card,
// and the loop takes the rest of the blocks.
constexpr int kMaxCtas = 132 * (2048 / kThreads);

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// y, cb, cr: the quantized natural-order blocks, (n, 64) int16 each (4n
// luma blocks for 4:2:0), 4 B aligned; n_groups restart groups of equal
// size, or prev_dc ((3,) int32 on the device) for the carried stream, with
// n_groups 1; luts: the packed table (SYM_LUT_WORDS int32); codes, lens:
// (B, 65) int32, B = 3n or 6n blocks in MCU order; block_bits: (B,) int32,
// each block's lengths summed; last_dc: (3,) int32, the DC of each
// component's last block.
extern "C" int symbol_streams_launch(const int16_t* y, const int16_t* cb, const int16_t* cr,
                                     int n_mcu, int s420, int n_groups, const int32_t* prev_dc,
                                     const int32_t* luts, int32_t* codes, int32_t* lens,
                                     int32_t* block_bits, int32_t* last_dc, void* stream) {
  const int n_blocks = n_mcu * (s420 ? 6 : 3);
  const int want = (n_blocks + kWarps - 1) / kWarps;
  const int ctas = want < kMaxCtas ? want : kMaxCtas;
  const uint64_t magic = sym_divides_magic((uint32_t)(n_mcu / n_groups));
  if (s420) {
    symbol_streams_kernel<true><<<ctas, kThreads, 0, (cudaStream_t)stream>>>(
        y, cb, cr, n_blocks, magic, prev_dc, luts, codes, lens, block_bits, last_dc);
  } else {
    symbol_streams_kernel<false><<<ctas, kThreads, 0, (cudaStream_t)stream>>>(
        y, cb, cr, n_blocks, magic, prev_dc, luts, codes, lens, block_bits, last_dc);
  }
  return (int)cudaGetLastError();
}
