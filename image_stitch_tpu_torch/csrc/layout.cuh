// JPEG encode: where each block of a band starts in the packed stream,
// shared by the CUDA kernel (layout.cu) and the serial host shim
// (host_shim.cpp).
//
// Same arithmetic as image_stitch_tpu_torch/ops/jpeg_entropy_device.py
// group_layout_plain. The band's B blocks make n_groups equal restart
// groups. Group g starts at word sum over h < g of used(h), used(h) =
// ceil(group_bits[h] / 32); inside a group the blocks follow one another bit
// by bit. The carried stream is one group that starts at bit_base. Start
// bits are kept modulo 2^32 (the plain version casts its int64 sums to
// int32), group_bits likewise; total_bits is a true 64-bit sum.
//
// The work is cut into chunks of LAYOUT_CHUNK blocks that never cross a
// group: chunks_per_group = ceil(B / n_groups / LAYOUT_CHUNK), chunk k is
// chunk k % chunks_per_group of group k / chunks_per_group. A chunk's
// aggregate is the 64-bit sum and the maximum of its blocks' bits; its base
// comes from the aggregates of the chunks before it (layout_used_words for
// each earlier group, the plain sum for the earlier chunks of its own).
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

#define LAYOUT_THREADS 256
#define LAYOUT_ITEMS 4
#define LAYOUT_CHUNK (LAYOUT_THREADS * LAYOUT_ITEMS)

// Words a group of `group_sum` bits takes: (int32(sum) + 31) >> 5 in int32,
// wrapping and shifting as torch does.
__host__ __device__ __forceinline__ int32_t layout_used_words(int64_t group_sum) {
  return (int32_t)((uint32_t)group_sum + 31u) >> 5;
}

struct LayoutChunk {
  int group, index;  // the chunk's group, and its place among the group's
  int first, count;  // its first block in the band, and how many it holds
};

__host__ __device__ __forceinline__ LayoutChunk layout_chunk(int k, int n_blocks, int n_groups,
                                                             int chunks_per_group) {
  LayoutChunk c;
  const int group_len = n_blocks / n_groups;
  c.group = k / chunks_per_group;
  c.index = k - c.group * chunks_per_group;
  const int at = c.index * LAYOUT_CHUNK;
  c.first = c.group * group_len + at;
  c.count = group_len - at < LAYOUT_CHUNK ? group_len - at : LAYOUT_CHUNK;
  return c;
}

// The start bit, modulo 2^32, of a chunk's first block: `words` the words
// of the groups before its group, `in_group` the bits of the chunks before
// it in its group, `bit_base` the carried stream's first bit (0 for restart
// groups, whose `words` are 0 in the carried form).
__host__ __device__ __forceinline__ uint32_t layout_chunk_base(uint32_t words, int64_t in_group,
                                                               int64_t bit_base) {
  return (words << 5) + (uint32_t)in_group + (uint32_t)bit_base;
}
