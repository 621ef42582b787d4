// Serial CPU build of the kernels' per-block bodies, for tests only.
//
// g++ compiles the kernels' .cuh bodies here without CUDA, so the test suite
// can hold the kernels' own arithmetic against the plain torch versions on
// a machine without a GPU. The encoder never loads this library.
#include <stddef.h>
#include <stdint.h>

#include "composite.cuh"
#include "fdct_quant.cuh"
#include "filter.cuh"
#include "idct.cuh"
#include "pack_merge.cuh"
#include "symbols.cuh"
#include "ycc.cuh"

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

// The IDCT of each block as the card's threads split it: the 8 column
// passes into the workspace, then the 8 row passes.
extern "C" void idct_dequant_host(const int16_t* zz, int n_blocks, int k, const int32_t* q,
                                  int bx, uint8_t* out) {
  static const uint8_t nat_to_zz[64] = JPEG_NATURAL_TO_ZIGZAG;
  for (int b = 0; b < n_blocks; ++b) {
    int64_t ws[8][8];  // [column][row]
    for (int c = 0; c < 8; ++c) idct_column(zz + (size_t)b * k, k, q, nat_to_zz, c, ws[c]);
    const int by = b / bx, bxi = b % bx;
    for (int r = 0; r < 8; ++r) {
      int64_t v[8];
      for (int c = 0; c < 8; ++c) v[c] = ws[c][r];
      idct_row(v, out + (size_t)(by * 8 + r) * (size_t)(bx * 8) + (size_t)bxi * 8);
    }
  }
}

// ycc_pixel at every pixel of the tile, into out's columns [x0, x0 + w).
extern "C" void ycc_rgba_host(const uint8_t* p0, const uint8_t* p1, const uint8_t* p2,
                              const int32_t* geom, int n_comp, uint8_t* out,
                              long long out_stride, int x0, int h, int w) {
  const uint8_t* planes[3] = {p0, p1, p2};
  YccComp comps[3];
  for (int i = 0; i < n_comp; ++i) {
    const int32_t* g = geom + 7 * i;
    comps[i] = YccComp{planes[i], g[0], g[1], g[2], g[3], g[4], g[5], g[6]};
  }
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      const uint32_t word = ycc_pixel(comps, n_comp, y, x);
      memcpy(out + (size_t)y * (size_t)out_stride + (size_t)(x0 + x) * 4, &word, 4);
    }
  }
}

// Each block of each component, in the kernel's orders.
extern "C" void fdct_quant_host(const uint8_t* band, int h, int w, int ch, const int32_t* lq,
                                const int32_t* cq, int s420, int16_t* y, int16_t* cb,
                                int16_t* cr) {
  const int n_luma = (h / 8) * (w / 8);
  int16_t* outs[3] = {y, cb, cr};
  for (int comp = 0; comp < 3; ++comp) {
    const int n = comp == 0 || !s420 ? n_luma : n_luma / 4;
    for (int i = 0; i < n; ++i) {
      int y0, x0;
      fdct_block_origin(i, comp, w, s420 != 0, &y0, &x0);
      int32_t s[64];
      fdct_gather(band, w, ch, comp, y0, x0, s420 != 0 && comp != 0, s);
      fdct_quant_block(s, comp == 0 ? lq : cq, outs[comp] + (size_t)i * 64);
    }
  }
}

// symbol_block_at for every block of the MCU sequence; prev_dc is null for
// restart groups.
extern "C" void symbol_streams_host(const int16_t* y, const int16_t* cb, const int16_t* cr,
                                    int n_mcu, int s420, int n_groups, const int32_t* prev_dc,
                                    const int32_t* luts, int32_t* codes, int32_t* lens) {
  static const uint8_t zigzag[64] = JPEG_ZIGZAG_ORDER;
  const int n_blocks = n_mcu * (s420 ? 6 : 3);
  for (int b = 0; b < n_blocks; ++b) {
    symbol_block_at(b, n_blocks, s420 != 0, n_groups, y, cb, cr, prev_dc, luts, zigzag,
                    codes + (size_t)b * SYM_SLOTS, lens + (size_t)b * SYM_SLOTS);
  }
}

// fdct_quantize of each (coefficient, quantizer) pair.
extern "C" void fdct_quantize_host(const int32_t* c, const int32_t* q, int16_t* out, int n) {
  for (int i = 0; i < n; ++i) out[i] = fdct_quantize(c[i], q[i]);
}
