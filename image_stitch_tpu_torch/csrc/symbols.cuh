// JPEG encode: the Huffman (code, length) slots of one block, shared by the
// CUDA kernel (symbols.cu) and the serial host shim (host_shim.cpp).
//
// Same arithmetic as image_stitch_tpu_torch/ops/jpeg_entropy_device.py
// symbol_streams_plain (_streams_from_diffs): a block's 65 slots are
// - slot 0, DC: the difference's size category s, its table's code << s,
//   then the value bits;
// - slots 1..63, the AC positions in zigzag order: a nonzero v gets the
//   (run % 16, size) symbol's code << size | value bits, run the zeros since
//   the last nonzero; a zero gets ZRL when it is the 16th zero of its run
//   and a later nonzero ends the run (position < the last nonzero's), else
//   nothing;
// - slot 64, EOB, unless position 63 is nonzero.
// Value bits of a negative v are (v + mask) & mask, mask = 2^size - 1. A
// slot of length 0 carries code 0. The size category is the bit length of
// |v|.
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

// Offsets into the packed int32 table (ops/jpeg_entropy_device.py
// pack_symbol_luts): row 0 luma, row 1 chroma.
#define SYM_DC_CODE 0     // (2, 16)
#define SYM_DC_LEN 32     // (2, 16)
#define SYM_AC_CODE 64    // (2, 256)
#define SYM_AC_LEN 576    // (2, 256)
#define SYM_ZRL_CODE 1088 // (2,)
#define SYM_ZRL_LEN 1090
#define SYM_EOB_CODE 1092
#define SYM_EOB_LEN 1094
#define SYM_LUT_WORDS 1096
#define SYM_SLOTS 65

__host__ __device__ __forceinline__ int sym_bit_size(int32_t v) {
  const uint32_t m = (uint32_t)(v < 0 ? -v : v);
#ifdef __CUDA_ARCH__
  return 32 - __clz(m);
#else
  return m ? 32 - __builtin_clz(m) : 0;
#endif
}

__host__ __device__ __forceinline__ int32_t sym_value_bits(int32_t v, int size) {
  const int32_t mask = (1 << size) - 1;
  return (v < 0 ? v + mask : v) & mask;
}

// blk: the block's 64 natural-order coefficients; diff: its DC difference;
// t: 0 luma, 1 chroma; lut: the packed table; zigzag: natural index of each
// zigzag position; codes, lens: the block's 65 slots.
__host__ __device__ __forceinline__ void symbol_block(const int16_t* blk, int32_t diff, int t,
                                                      const int32_t* lut, const uint8_t* zigzag,
                                                      int32_t* codes, int32_t* lens) {
  const int ds = sym_bit_size(diff);
  const int32_t dc_len = lut[SYM_DC_LEN + 16 * t + ds] + ds;
  codes[0] = dc_len > 0 ? (lut[SYM_DC_CODE + 16 * t + ds] << ds) | sym_value_bits(diff, ds) : 0;
  lens[0] = dc_len;
  int last = 0;
  for (int p = 63; p > 0; --p) {
    if (blk[zigzag[p]] != 0) {
      last = p;
      break;
    }
  }
  int prev = 0;  // position of the last nonzero so far, 0 for none
  for (int p = 1; p < 64; ++p) {
    const int32_t v = blk[zigzag[p]];
    int32_t code = 0, len = 0;
    if (v != 0) {
      const int s = sym_bit_size(v);
      const int sym = (((p - prev - 1) & 15) << 4) | s;
      len = lut[SYM_AC_LEN + 256 * t + sym] + s;
      code = (lut[SYM_AC_CODE + 256 * t + sym] << s) | sym_value_bits(v, s);
      prev = p;
    } else if (((p - prev) & 15) == 0 && p < last) {
      len = lut[SYM_ZRL_LEN + t];
      code = lut[SYM_ZRL_CODE + t];
    }
    codes[p] = len > 0 ? code : 0;
    lens[p] = len;
  }
  const int32_t eob_len = last != 63 ? lut[SYM_EOB_LEN + t] : 0;
  codes[64] = eob_len > 0 ? lut[SYM_EOB_CODE + t] : 0;
  lens[64] = eob_len;
}

// Block b of the MCU sequence (per MCU: 1 or 4 luma blocks, then Cb, then
// Cr): its component and its index among that component's blocks.
__host__ __device__ __forceinline__ void symbol_block_source(int b, bool s420, int* comp,
                                                             int* i) {
  const int per = s420 ? 6 : 3;
  const int m = b / per, j = b - m * per;
  const int luma = s420 ? 4 : 1;
  if (j < luma) {
    *comp = 0;
    *i = m * luma + j;
  } else {
    *comp = j - luma + 1;
    *i = m;
  }
}

// The 65 slots of block b of the MCU sequence of n_blocks blocks. The DC
// difference is taken from the previous block of the same component; the
// chain starts from 0 at each of n_groups equal restart groups, or, with
// prev_dc (one group), from prev_dc[comp].
__host__ __device__ __forceinline__ void symbol_block_at(int b, int n_blocks, bool s420,
                                                         int n_groups, const int16_t* y,
                                                         const int16_t* cb, const int16_t* cr,
                                                         const int32_t* prev_dc,
                                                         const int32_t* lut,
                                                         const uint8_t* zigzag, int32_t* codes,
                                                         int32_t* lens) {
  int comp, i;
  symbol_block_source(b, s420, &comp, &i);
  const int n_comp_blocks = (n_blocks / (s420 ? 6 : 3)) * (comp == 0 && s420 ? 4 : 1);
  const int group_len = n_comp_blocks / n_groups;
  const int16_t* blk = (comp == 0 ? y : (comp == 1 ? cb : cr)) + (size_t)i * 64;
  int32_t prev;
  if (i % group_len == 0) {
    prev = prev_dc != nullptr ? prev_dc[comp] : 0;
  } else {
    prev = blk[-64];
  }
  symbol_block(blk, (int32_t)blk[0] - prev, comp == 0 ? 0 : 1, lut, zigzag, codes, lens);
}
