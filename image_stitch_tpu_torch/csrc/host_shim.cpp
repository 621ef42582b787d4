// Serial CPU build of the kernels' per-block bodies, for tests only.
//
// g++ compiles the kernels' .cuh bodies here without CUDA, so the test suite
// can hold the kernels' own arithmetic against the plain torch versions on
// a machine without a GPU. The encoder never loads this library.
#include <stddef.h>
#include <stdint.h>

#include "composite.cuh"
#include "filter.cuh"
#include "pack_merge.cuh"

// The pairs of each block run in order with a running sum of their lengths:
// the serial chain that the kernel's warp scan reproduces.
extern "C" void pack_merge_host(const int32_t* codes, const int32_t* lens,
                                const int32_t* starts, int32_t* dense, int nb,
                                int n_sym, int n_aw, int n_words) {
  uint32_t stage[PACK_MAX_AW];
  for (int b = 0; b < nb; ++b) {
    const size_t row = (size_t)b * (size_t)n_sym;
    for (int c = 0; c < n_aw; ++c) stage[c] = 0u;
    int off = starts[b] & 31;
    for (int s = 0; s < n_sym; s += 2) {
      const bool has2 = s + 1 < n_sym;
      const uint32_t c2 = has2 ? (uint32_t)codes[row + s + 1] : 0u;
      const int l2 = has2 ? lens[row + s + 1] : 0;
      off += lens[row + s] + l2;
      const PairWords pw =
          pair_words((uint32_t)codes[row + s], c2, l2, off, n_aw);
      for (int k = 0; k < 3; ++k) stage[pw.idx[k]] |= pw.val[k];
    }
    for (int c = 0; c < n_aw; ++c) {
      const int idx = dense_index(starts[b], c, n_words);
      if (idx >= 0) ((uint32_t*)dense)[idx] += stage[c];
    }
  }
}

// words = 1 runs the word form (bpp 4 or 8, n % 4 == 0), as the card's
// word kernel; 0 the byte form, as its byte kernel.
extern "C" void filter_select_host(const uint8_t* band, const uint8_t* prev,
                                   uint8_t* filtered, uint8_t* types, int h,
                                   int n, int bpp, int swap, int words) {
  for (int r = 0; r < h; ++r) {
    const uint8_t* raw = band + (size_t)r * (size_t)n;
    const uint8_t* up = r ? raw - n : prev;
    uint8_t* out = filtered + (size_t)r * (size_t)n;
    types[r] = (uint8_t)(words ? filter_row_words(raw, swap, up, r ? swap : 0, n, bpp, out)
                               : filter_row_serial(raw, swap, up, r ? swap : 0, n, bpp, out));
  }
}

// Filter k's residue word for each (x, a, b, c) word into out, and the
// score of each residue word into scores.
extern "C" void filter_words_host(int k, const uint32_t* x, const uint32_t* a,
                                  const uint32_t* b, const uint32_t* c,
                                  uint32_t* out, uint32_t* scores, int n) {
  for (int i = 0; i < n; ++i) {
    out[i] = filter_word_residue(k, x[i], a[i], b[i], c[i]);
    scores[i] = filter_add_score4(0u, out[i]);
  }
}

// composite_divmod of each (num, den): quotients into q, remainders into r.
extern "C" void composite_divmod_host(const int32_t* num, const int32_t* den,
                                      int32_t* q, int32_t* r, int n) {
  for (int i = 0; i < n; ++i) {
    int rem;
    q[i] = composite_divmod(num[i], den[i], composite_recip(den[i]), &rem);
    r[i] = rem;
  }
}

// alpha_over_px of each source pixel over its destination, in place.
// Returns the ties.
extern "C" int alpha_over_host(const uint32_t* s, uint32_t* d, int n) {
  int ties = 0;
  for (int i = 0; i < n; ++i) d[i] = alpha_over_px(s[i], d[i], &ties);
  return ties;
}

// The card's tile walk, serially: per tile, the segments culled
// COMPOSITE_CHUNK at a time into a list in z order, each list blended over
// every run of the tile, the runs' pixels kept from one chunk to the next.
extern "C" int composite_segments_host(const int64_t* metas, int s_count,
                                       const uint8_t* srcs,
                                       const uint8_t* bg, uint8_t* out, int h,
                                       int w) {
  const uint32_t bgw = (uint32_t)bg[0] | ((uint32_t)bg[1] << 8) |
                       ((uint32_t)bg[2] << 16) | ((uint32_t)bg[3] << 24);
  const int runs_per_row = COMPOSITE_TILE_W / COMPOSITE_RUN;
  uint32_t d[COMPOSITE_TILE_H * COMPOSITE_TILE_W];
  CompositeHit hits[COMPOSITE_CHUNK];
  int ties = 0;
  for (int ty0 = 0; ty0 < h; ty0 += COMPOSITE_TILE_H) {
    for (int tx0 = 0; tx0 < w; tx0 += COMPOSITE_TILE_W) {
      const int th = h - ty0 < COMPOSITE_TILE_H ? h - ty0 : COMPOSITE_TILE_H;
      const int tw = w - tx0 < COMPOSITE_TILE_W ? w - tx0 : COMPOSITE_TILE_W;
      for (int i = 0; i < COMPOSITE_TILE_H * COMPOSITE_TILE_W; ++i) d[i] = bgw;
      for (int base = 0; base < s_count; base += COMPOSITE_CHUNK) {
        int count = 0;
        for (int s = base; s < s_count && s < base + COMPOSITE_CHUNK; ++s) {
          count += composite_cull(metas + (size_t)s * META_COLS, srcs, ty0, tx0,
                                  th, tw, &hits[count]);
        }
        for (int t = 0; t < COMPOSITE_TILE_H * runs_per_row; ++t) {
          const int y = ty0 + t / runs_per_row;
          const int x = tx0 + (t % runs_per_row) * COMPOSITE_RUN;
          if (y >= h || x >= w) continue;
          for (int i = 0; i < count; ++i) {
            ties += composite_apply(hits[i], y, x, d + t * COMPOSITE_RUN);
          }
        }
      }
      for (int t = 0; t < COMPOSITE_TILE_H * runs_per_row; ++t) {
        const int y = ty0 + t / runs_per_row;
        const int x = tx0 + (t % runs_per_row) * COMPOSITE_RUN;
        for (int i = 0; i < COMPOSITE_RUN && y < h && x + i < w; ++i) {
          memcpy(out + ((size_t)y * (size_t)w + (size_t)(x + i)) * 4,
                 d + t * COMPOSITE_RUN + i, 4);
        }
      }
    }
  }
  return ties;
}
