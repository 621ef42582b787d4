// JPEG encode: the Huffman (code, length) slots of one block, shared by the
// CUDA kernel (symbols.cu) and the serial host shim (host_shim.cpp).
//
// Same arithmetic as image_stitch_tpu_torch/ops/jpeg_entropy_device.py
// symbol_streams_plain (_streams_from_diffs), slot by slot (symbol_slot): the
// kernel gives a warp's lanes two slots each, the shim runs them in a loop,
// both from the block's masks of nonzero positions.
// A block's 65 slots are
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

// The kernel's table in shared memory: one word per symbol, code | len <<
// 16 (a Huffman code has at most 16 bits), made from the packed table by
// symbol_combined_entry; row 0 luma, row 1 chroma.
#define SYMC_DC 0     // (2, 16)
#define SYMC_AC 32    // (2, 256)
#define SYMC_ZRL 544  // (2,)
#define SYMC_EOB 546  // (2,)
#define SYMC_WORDS 548

__host__ __device__ __forceinline__ uint32_t symbol_combined_entry(const int32_t* packed,
                                                                   int j) {
  int code_at, len_at;
  if (j < SYMC_AC) {
    code_at = SYM_DC_CODE + j;
    len_at = SYM_DC_LEN + j;
  } else if (j < SYMC_ZRL) {
    code_at = SYM_AC_CODE + j - SYMC_AC;
    len_at = SYM_AC_LEN + j - SYMC_AC;
  } else if (j < SYMC_EOB) {
    code_at = SYM_ZRL_CODE + j - SYMC_ZRL;
    len_at = SYM_ZRL_LEN + j - SYMC_ZRL;
  } else {
    code_at = SYM_EOB_CODE + j - SYMC_EOB;
    len_at = SYM_EOB_LEN + j - SYMC_EOB;
  }
  return ((uint32_t)packed[code_at] & 0xffffu) | ((uint32_t)packed[len_at] << 16);
}

// Position of the highest set bit of m, m != 0.
__host__ __device__ __forceinline__ int sym_high_bit(uint32_t m) {
#ifdef __CUDA_ARCH__
  return 31 - __clz((int)m);
#else
  return 31 - __builtin_clz(m);
#endif
}

// A block's nonzero AC positions are two 32-bit masks, as two warp ballots
// give them: bit p of lo for zigzag positions 1..31 (bit 0 clear), bit p -
// 32 of hi for positions 32..63. From the masks alone, with no walk over the
// block: the last nonzero position of the block, and the last nonzero
// position before p (0 for none), for p below 32 and from 32 on.
__host__ __device__ __forceinline__ int symbol_last(uint32_t lo, uint32_t hi) {
  return hi ? 32 + sym_high_bit(hi) : (lo ? sym_high_bit(lo) : 0);
}

__host__ __device__ __forceinline__ int symbol_prev_low(int p, uint32_t lo) {
  const uint32_t below = lo & ((1u << p) - 1u);
  return below ? sym_high_bit(below) : 0;
}

__host__ __device__ __forceinline__ int symbol_prev_high(int p, uint32_t lo, uint32_t hi) {
  const uint32_t below = hi & ((1u << (p - 32)) - 1u);
  return below ? 32 + sym_high_bit(below) : (lo ? sym_high_bit(lo) : 0);
}

struct SymSlot {
  int32_t code, len;
};

// Slot p of a block, 0..63, without a branch: the DC slot (dc: v is the DC
// difference, coded even when 0) and an AC slot (v the coefficient at
// zigzag position p, prev the last nonzero position before p, last the
// block's last) differ only in the table entry they read. t: 0 luma, 1
// chroma; comb: the combined table.
__host__ __device__ __forceinline__ SymSlot symbol_code(bool dc, int p, int prev, int last,
                                                        int32_t v, int t, const uint32_t* comb) {
  const bool coded = dc || v != 0;
  const int s = sym_bit_size(v);
  const int run = (p - prev - 1) & 15;
  const int sym_at = dc ? SYMC_DC + 16 * t + s : SYMC_AC + 256 * t + ((run << 4) | s);
  const bool zrl = !coded && ((p - prev) & 15) == 0 && p < last;
  const uint32_t e = (coded || zrl) ? comb[coded ? sym_at : SYMC_ZRL + t] : 0u;
  SymSlot out;
  out.len = (coded || zrl) ? (int32_t)(e >> 16) + s : 0;
  out.code = out.len > 0 ? (int32_t)(((e & 0xffffu) << s) | (uint32_t)sym_value_bits(v, s)) : 0;
  return out;
}

// Slot 64, EOB, unless position 63 is nonzero.
__host__ __device__ __forceinline__ SymSlot symbol_eob(uint32_t hi, int t, const uint32_t* comb) {
  const uint32_t e = (hi >> 31) ? 0u : comb[SYMC_EOB + t];
  SymSlot out;
  out.len = (int32_t)(e >> 16);
  out.code = out.len > 0 ? (int32_t)(e & 0xffffu) : 0;
  return out;
}

// Slot p of a block, 0..64, from the masks and the slot's own value (the DC
// difference for p = 0; not read for p = 64): the pieces above, as the
// kernel's lanes put them together.
__host__ __device__ __forceinline__ SymSlot symbol_slot(int p, uint32_t lo, uint32_t hi,
                                                        int32_t v, int t, const uint32_t* comb) {
  if (p == 64) return symbol_eob(hi, t, comb);
  const int prev = p < 32 ? symbol_prev_low(p, lo) : symbol_prev_high(p, lo, hi);
  return symbol_code(p == 0, p, prev, symbol_last(lo, hi), v, t, comb);
}

// The MCU sequence: per MCU 1 or 4 luma blocks, then Cb, then Cr.

// n % d == 0 without a division (Lemire and Kaser's test): with magic =
// floor((2^64 - 1) / d) + 1, d >= 1, it holds exactly when n * magic, modulo
// 2^64, is at most magic - 1, for every 32-bit n.
__host__ __device__ __forceinline__ uint64_t sym_divides_magic(uint32_t d) {
  return 0xFFFFFFFFFFFFFFFFull / d + 1ull;
}

__host__ __device__ __forceinline__ bool sym_divides(uint32_t n, uint64_t magic) {
  return (uint64_t)n * magic <= magic - 1ull;
}

// Block b of the MCU sequence of n_blocks blocks: its coefficients, its
// component and the DC it is predicted from, that of the previous block of
// the same component; the chain starts from 0 at each of n_groups equal
// restart groups, or, with prev_dc (one group), from prev_dc[comp]: at a
// component's first block of an MCU whose number the group's MCU count
// divides (group_magic = sym_divides_magic(MCUs per group), which the caller
// makes once). `last` is set where the block is its component's last.
struct SymBlock {
  const int16_t* blk;
  int32_t pred;
  int comp;
  bool last;
};

__host__ __device__ __forceinline__ SymBlock symbol_block_locate(int b, int n_blocks, bool s420,
                                                                 uint64_t group_magic,
                                                                 const int16_t* y,
                                                                 const int16_t* cb,
                                                                 const int16_t* cr,
                                                                 const int32_t* prev_dc) {
  SymBlock out;
  const int per = s420 ? 6 : 3;
  const int luma = s420 ? 4 : 1;
  const int m = b / per, j = b - m * per;
  out.comp = j < luma ? 0 : j - luma + 1;
  const int k = out.comp == 0 ? luma : 1;  // the component's blocks per MCU
  const int i = out.comp == 0 ? m * luma + j : m;
  out.blk = (out.comp == 0 ? y : (out.comp == 1 ? cb : cr)) + (size_t)i * 64;
  const bool first = (out.comp != 0 || j == 0) && sym_divides((uint32_t)m, group_magic);
  if (first) {
    out.pred = prev_dc != nullptr ? prev_dc[out.comp] : 0;
  } else {
    out.pred = out.blk[-64];
  }
  out.last = i == (n_blocks / per) * k - 1;
  return out;
}
