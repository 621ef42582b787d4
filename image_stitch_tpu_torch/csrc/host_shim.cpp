// Serial CPU build of the kernels' per-block bodies, for tests only.
//
// g++ compiles the kernels' .cuh bodies here without CUDA, so the test suite
// can hold the kernels' own arithmetic against the plain torch versions on
// a machine without a GPU. The encoder never loads this library.
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

#include <vector>

#include "composite.cuh"
#include "fdct_quant.cuh"
#include "filter.cuh"
#include "grid_dual.cuh"
#include "idct.cuh"
#include "layout.cuh"
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

// The batched IDCT as the card's CTAs split it: each CTA's row of the CTA
// table, and per live block the 8 chunks staged into the 32-bit workspace,
// the 8 column passes (32 or 64 bits by the flag), the 8 row passes.
extern "C" void idct_dequant_batch_host(const int16_t* coefs, const int32_t* qtabs,
                                        const int32_t* ctas, int n_ctas, uint8_t* planes) {
  static const uint8_t zz_to_ws[64] = IDCT_ZIGZAG_WS;
  for (int c = 0; c < n_ctas; ++c) {
    const int32_t* cta = ctas + (size_t)c * IDCT_CTA_COLS;
    const int k = cta[IDCT_CTA_K];
    const bool narrow = (cta[IDCT_CTA_FLAGS] & IDCT_JOB_INT32) != 0;
    for (int local = 0; local < cta[IDCT_CTA_LIVE]; ++local) {
      uint32_t ws[IDCT_WS_BLOCK];
      for (int j = 0; j < 8; ++j) {
        int16_t zz8[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        int32_t q8[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        if (8 * j < k) {
          memcpy(zz8, coefs + (size_t)cta[IDCT_CTA_COEF] + (size_t)(local * k + 8 * j), 16);
          memcpy(q8, qtabs + (size_t)cta[IDCT_CTA_QTAB] * 64 + 8 * j, 32);
        }
        idct_stage_chunk(zz8, q8, zz_to_ws + 8 * j, ws);
      }
      for (int col = 0; col < 8; ++col) idct_column_ws(ws, col, narrow);
      for (int r = 0; r < 8; ++r) {
        uint32_t px[2];
        idct_row_ws(ws, r, px);
        memcpy(planes + idct_block_row_at(cta, local, r), px, 8);
      }
    }
  }
}

// idct_range_limit_u32 of each value beside idct_range_limit of the same
// value sign-extended: the two forms of the range limit.
extern "C" void idct_range_limit_host(const uint32_t* x, uint8_t* narrow, uint8_t* wide,
                                      int n) {
  for (int i = 0; i < n; ++i) {
    narrow[i] = (uint8_t)idct_range_limit_u32(x[i]);
    wide[i] = idct_range_limit((int64_t)(int32_t)x[i]);
  }
}

// One pass over 8 values in 64 bits, descaled by n bits, in place. Twice a
// unit vector with n = 1 gives the pass's matrix column, from which the
// tests take IDCT_PASS_L1.
extern "C" void idct_pass_host(int64_t* v, int n) { idct_islow_pass(v, n); }

// The batched colour kernel as the card's grid splits it: per tile, the
// CTAs across the widest tile and down the band, each thread's octet
// through ycc_octet_by_layout (the specialisation for the tile's sampling).
extern "C" void ycc_rgba_batch_host(const uint8_t* planes, const int32_t* tiles, int n_tiles,
                                    int max_w, uint8_t* out, long long out_stride, int h) {
  const int ctas_x = ((max_w + 7) / 8 + YCC_CTA_OCTETS - 1) / YCC_CTA_OCTETS;
  const int ctas_y = (h + YCC_CTA_ROWS - 1) / YCC_CTA_ROWS;
  for (int t = 0; t < n_tiles; ++t) {
    const int32_t* tile = tiles + (size_t)t * YCC_TILE_COLS;
    const int n_comp = tile[YCC_TILE_NCOMP], w = tile[YCC_TILE_W];
    YccComp comps[3];
    for (int i = 0; i < 3; ++i) comps[i] = ycc_tile_comp(planes, tile, i < n_comp ? i : 0);
    for (int cta = 0; cta < ctas_x * ctas_y; ++cta) {
      for (int thread = 0; thread < YCC_CTA_OCTETS * YCC_CTA_ROWS; ++thread) {
        const int x = 8 * ((cta % ctas_x) * YCC_CTA_OCTETS + thread % YCC_CTA_OCTETS);
        const int y = (cta / ctas_x) * YCC_CTA_ROWS + thread / YCC_CTA_OCTETS;
        if (x >= w || y >= h) continue;
        const int n = w - x < 8 ? w - x : 8;
        uint32_t px[8];
        ycc_octet_by_layout(comps, n_comp, y, x, n, px);
        memcpy(out + (size_t)y * (size_t)out_stride + (size_t)(tile[YCC_TILE_X0] + x) * 4, px,
               (size_t)n * 4);
      }
    }
  }
}

// Eight pixels from p, ch bytes apart, as the kernel's byte loads.
static void fdct_load8(const uint8_t* p, int ch, int32_t r[8], int32_t g[8], int32_t b[8]) {
  for (int i = 0; i < 8; ++i) {
    r[i] = p[i * ch];
    g[i] = p[i * ch + 1];
    b[i] = p[i * ch + 2];
  }
}

// The band as the card's threads split it: a row task per 8 pixels (colour
// once, the row passes of all components; 4:2:0: two rows and their chroma
// boxes, then a row pass per row of boxes), the rows kept in a workspace,
// then a column task per block column (column pass, reciprocal quantizer),
// in the kernel's block orders.
extern "C" void fdct_quant_host(const uint8_t* band, int h, int w, int ch, const int32_t* lq,
                                const int32_t* cq, int s420, int16_t* y, int16_t* cb,
                                int16_t* cr) {
  const int32_t* q[2] = {lq, cq};
  uint32_t m[2][64];
  for (int t = 0; t < 2; ++t) {
    for (int i = 0; i < 64; ++i) m[t][i] = fdct_recip(q[t][i]);
  }
  int16_t* outs[3] = {y, cb, cr};
  if (!s420) {
    const int n = (h / 8) * (w / 8);
    for (int i = 0; i < n; ++i) {
      int y0, x0;
      fdct_block_origin(i, 0, w, false, &y0, &x0);
      int32_t ws[3][64];
      for (int k = 0; k < 8; ++k) {
        int32_t r[8], g[8], b[8];
        fdct_load8(band + ((size_t)(y0 + k) * w + x0) * ch, ch, r, g, b);
        fdct_row_444(r, g, b, ws[0] + 8 * k, ws[1] + 8 * k, ws[2] + 8 * k);
      }
      for (int c = 0; c < 8; ++c) {
        for (int comp = 0; comp < 3; ++comp) {
          const int t = comp != 0;
          int32_t v[8];
          for (int r = 0; r < 8; ++r) v[r] = ws[comp][r * 8 + c];
          fdct_column(v, c, q[t], m[t], outs[comp] + (size_t)i * 64 + c, 8);
        }
      }
    }
    return;
  }
  const int n_mcu = (h / 16) * (w / 16);
  for (int mi = 0; mi < n_mcu; ++mi) {
    int y0, x0;
    fdct_block_origin(mi, 1, w, true, &y0, &x0);
    int32_t luma[16][16], chroma[2][8][8];
    for (int k = 0; k < 8; ++k) {
      for (int hi = 0; hi < 2; ++hi) {
        int32_t px[2][3][8], yy[2][8];
        for (int a = 0; a < 2; ++a) {
          fdct_load8(band + ((size_t)(y0 + 2 * k + a) * w + x0 + hi * 8) * ch, ch, px[a][0],
                     px[a][1], px[a][2]);
        }
        fdct_patch_420(px, yy, chroma[0][k] + hi * 4, chroma[1][k] + hi * 4);
        for (int a = 0; a < 2; ++a) {
          for (int i = 0; i < 8; ++i) luma[2 * k + a][hi * 8 + i] = yy[a][i];
        }
      }
    }
    for (int comp = 0; comp < 2; ++comp) {
      for (int k = 0; k < 8; ++k) fdct_pass(chroma[comp][k], 1, false);
    }
    for (int c = 0; c < 8; ++c) {
      int32_t v[8];
      for (int j = 0; j < 4; ++j) {  // TL, TR, BL, BR
        for (int r = 0; r < 8; ++r) v[r] = luma[(j >> 1) * 8 + r][(j & 1) * 8 + c];
        fdct_column(v, c, q[0], m[0], y + ((size_t)mi * 4 + j) * 64 + c, 8);
      }
      for (int comp = 0; comp < 2; ++comp) {
        for (int r = 0; r < 8; ++r) v[r] = chroma[comp][r][c];
        fdct_column(v, c, q[1], m[1], outs[1 + comp] + (size_t)mi * 64 + c, 8);
      }
    }
  }
}

// Every block of the MCU sequence as a warp takes it: the two masks of its
// nonzero AC positions (the kernel's ballots), then symbol_slot for each of
// the 65 slots from the masks and the slot's own value, with the table
// combined as the kernel stages it, and the sum of the lengths. prev_dc is
// null for restart groups.
extern "C" void symbol_streams_host(const int16_t* y, const int16_t* cb, const int16_t* cr,
                                    int n_mcu, int s420, int n_groups, const int32_t* prev_dc,
                                    const int32_t* luts, int32_t* codes, int32_t* lens,
                                    int32_t* block_bits, int32_t* last_dc) {
  static const uint8_t zigzag[64] = JPEG_ZIGZAG_ORDER;
  uint32_t comb[SYMC_WORDS];
  for (int j = 0; j < SYMC_WORDS; ++j) comb[j] = symbol_combined_entry(luts, j);
  const int n_blocks = n_mcu * (s420 ? 6 : 3);
  const uint64_t magic = sym_divides_magic((uint32_t)(n_mcu / n_groups));
  for (int b = 0; b < n_blocks; ++b) {
    const SymBlock sb = symbol_block_locate(b, n_blocks, s420 != 0, magic, y, cb, cr, prev_dc);
    const int t = sb.comp == 0 ? 0 : 1;
    uint32_t lo = 0, hi = 0;
    for (int p = 1; p < 32; ++p) lo |= (uint32_t)(sb.blk[zigzag[p]] != 0) << p;
    for (int p = 32; p < 64; ++p) hi |= (uint32_t)(sb.blk[zigzag[p]] != 0) << (p - 32);
    if (sb.last) last_dc[sb.comp] = sb.blk[0];
    int32_t bits = 0;
    for (int p = 0; p <= 64; ++p) {
      const int32_t v = p == 0 ? (int32_t)sb.blk[0] - sb.pred : (p < 64 ? sb.blk[zigzag[p]] : 0);
      const SymSlot slot = symbol_slot(p, lo, hi, v, t, comb);
      codes[(size_t)b * SYM_SLOTS + p] = slot.code;
      lens[(size_t)b * SYM_SLOTS + p] = slot.len;
      bits += slot.len;
    }
    block_bits[b] = bits;
  }
}

// The layout as the card's CTAs split it: each chunk's own scan and
// aggregate first, then each chunk's base from the aggregates of the chunks
// before it. bit_base and totals are null for restart groups.
extern "C" void group_layout_host(const int32_t* block_bits, int n_blocks, int n_groups,
                                  const int64_t* bit_base, int32_t* starts, int32_t* group_bits,
                                  int32_t* max_bits, int64_t* totals) {
  const int group_len = n_blocks / n_groups;
  const int cpg = (group_len + LAYOUT_CHUNK - 1) / LAYOUT_CHUNK;
  const int n_chunks = n_groups * cpg;
  std::vector<int64_t> agg(n_chunks);
  std::vector<int32_t> amax(n_chunks);
  for (int k = 0; k < n_chunks; ++k) {
    const LayoutChunk ck = layout_chunk(k, n_blocks, n_groups, cpg);
    uint32_t at = 0u;
    agg[k] = 0;
    amax[k] = INT_MIN;
    for (int i = 0; i < ck.count; ++i) {
      const int32_t v = block_bits[ck.first + i];
      starts[ck.first + i] = (int32_t)at;  // within the chunk, until its base is known
      at += (uint32_t)v;
      agg[k] += v;
      amax[k] = v > amax[k] ? v : amax[k];
    }
  }
  const int64_t base_bit = bit_base != nullptr ? *bit_base : 0;
  for (int k = 0; k < n_chunks; ++k) {
    const LayoutChunk ck = layout_chunk(k, n_blocks, n_groups, cpg);
    uint32_t words = 0u;
    int64_t in_group = 0;
    int32_t mx = INT_MIN;
    for (int h = 0; h < ck.group; ++h) {
      int64_t group_sum = 0;
      for (int c = 0; c < cpg; ++c) {
        group_sum += agg[h * cpg + c];
        mx = amax[h * cpg + c] > mx ? amax[h * cpg + c] : mx;
      }
      words += (uint32_t)layout_used_words(group_sum);
    }
    for (int c = 0; c < ck.index; ++c) {
      in_group += agg[ck.group * cpg + c];
      mx = amax[ck.group * cpg + c] > mx ? amax[ck.group * cpg + c] : mx;
    }
    const uint32_t base = layout_chunk_base(words, in_group, base_bit);
    for (int i = 0; i < ck.count; ++i) {
      starts[ck.first + i] = (int32_t)((uint32_t)starts[ck.first + i] + base);
    }
    const int64_t group_sum = in_group + agg[k];
    if (ck.index == cpg - 1) group_bits[ck.group] = (int32_t)group_sum;
    if (k == n_chunks - 1) {
      *max_bits = amax[k] > mx ? amax[k] : mx;
      if (totals != nullptr) {
        totals[0] = base_bit + group_sum;
        totals[1] = (base_bit + group_sum) & 7;
      }
    }
  }
}

// sym_divides(n, sym_divides_magic(d)) for each (n, d) pair.
extern "C" void sym_divides_host(const uint32_t* n, const uint32_t* d, uint8_t* out, int count) {
  for (int i = 0; i < count; ++i) out[i] = sym_divides(n[i], sym_divides_magic(d[i]));
}

// fdct_quantize of each (coefficient, quantizer) pair: the exact division.
extern "C" void fdct_quantize_host(const int32_t* c, const int32_t* q, int16_t* out, int n) {
  for (int i = 0; i < n; ++i) out[i] = fdct_quantize(c[i], q[i]);
}

// The same by reciprocal, as the kernel takes it.
extern "C" void fdct_quantize_recip_host(const int32_t* c, const int32_t* q, int16_t* out,
                                         int n) {
  for (int i = 0; i < n; ++i) out[i] = fdct_quantize_recip(c[i], q[i], fdct_recip(q[i]));
}

// grid_dual_ctas: the CTAs of a launch over `rows` rows of w pixels.
extern "C" int grid_dual_ctas_host(int rows, int w) { return grid_dual_ctas(rows, w); }

// The fused grid step as the card's CTAs split it: per 8-row strip, each
// CTA of the strip (grid_dual_split) walks its chunk's windows,
// each window in its 8 warps' slices: the slice's rows and the row above
// from the tile stack (grid_pixel) into a buffer laid out as a warp's
// shared memory, the slice's blocks (fdct_row_444 per block row,
// fdct_column per block column) and each row's five sums of the warp
// (filter_word_scores), added over the CTA's warps; then each row's filter
// from the CTAs' sums in rank order (grid_dual_choose), and the chosen
// residues (filter_word_residue), slice by slice, the rows loaded again.
extern "C" void grid_dual_host(const uint8_t* tiles, const uint8_t* prev, int gx, int th,
                               int tw, int r0, int r1, const int32_t* lq, const int32_t* cq,
                               int png, int jpeg, int32_t* types, uint8_t* filtered,
                               uint8_t* last, int16_t* y, int16_t* cb, int16_t* cr) {
  const int w = gx * tw;
  const int rows = r1 - r0;
  const int warps = GRID_DUAL_THREADS / 32;
  const GridDualSplit sp = grid_dual_split(w);
  const int stride = grid_dual_stride(sp.win_px);
  const int slice_px = grid_dual_slice_px(sp.win_px);
  std::vector<uint32_t> raw((size_t)(GRID_DUAL_ROWS + 1) * (size_t)stride);
  std::vector<uint32_t> partial((size_t)sp.ctas * GRID_DUAL_ROWS * FILTER_COUNT);
  const int32_t* q[2] = {lq, cq};
  uint32_t m[2][64];
  for (int t = 0; jpeg && t < 2; ++t) {
    for (int i = 0; i < 64; ++i) m[t][i] = fdct_recip(q[t][i]);
  }
  int16_t* outs[3] = {y, cb, cr};
  // Raw row j = canvas row row_first + j over [xs, x_end), the word before
  // xs at index GRID_DUAL_PAD - 1 (0 at the canvas's edge); row 0, the row
  // above, only for the PNG half.
  auto load = [&](int row_first, int n_rows, int xs, int x_end) {
    for (int j = png ? 0 : 1; j <= n_rows; ++j) {
      uint32_t* row = raw.data() + (size_t)j * stride + GRID_DUAL_PAD;
      row[-1] = 0u;
      if (xs > 0) memcpy(&row[-1], grid_pixel(tiles, prev, row_first + j, xs - 1, gx, th, tw), 4);
      for (int x = xs; x < x_end; ++x) {
        memcpy(&row[x - xs], grid_pixel(tiles, prev, row_first + j, x, gx, th, tw), 4);
      }
    }
  };
  // Each warp slice [xs, x_end) of CTA `rank`, in the kernel's order.
  auto slices = [&](int rank, auto&& body) {
    const int x_lo = rank * sp.chunk_px;
    const int x_hi = x_lo + sp.chunk_px < w ? x_lo + sp.chunk_px : w;
    for (int win = 0; win < sp.windows; ++win) {
      for (int warp = 0; warp < warps; ++warp) {
        const int xs = x_lo + win * sp.win_px + warp * slice_px;
        const int x_end = x_hi < xs + slice_px ? x_hi : xs + slice_px;
        if (x_end > xs) body(warp, xs, x_end);
      }
    }
  };
  for (int strip = 0; strip * GRID_DUAL_ROWS < rows; ++strip) {
    const int n_rows = rows - strip * GRID_DUAL_ROWS < GRID_DUAL_ROWS
                           ? rows - strip * GRID_DUAL_ROWS : GRID_DUAL_ROWS;
    const int row_first = r0 + strip * GRID_DUAL_ROWS - 1;
    const bool last_strip = strip * GRID_DUAL_ROWS + n_rows == rows;
    for (int rank = 0; rank < sp.ctas; ++rank) {
      std::vector<uint32_t> wsums((size_t)warps * GRID_DUAL_ROWS * FILTER_COUNT, 0u);
      slices(rank, [&](int warp, int xs, int x_end) {
        load(row_first, n_rows, xs, x_end);
        for (int px = xs; jpeg && px < x_end; px += 8) {
          int32_t ws[3][64];
          for (int k = 0; k < 8; ++k) {
            uint32_t px8[8];
            memcpy(px8, raw.data() + (size_t)(k + 1) * stride + GRID_DUAL_PAD + (px - xs), 32);
            int32_t r[8], g[8], b[8];
            grid_rgb8(px8, r, g, b);
            fdct_row_444(r, g, b, ws[0] + 8 * k, ws[1] + 8 * k, ws[2] + 8 * k);
          }
          const size_t index = (size_t)strip * (size_t)(w / 8) + (size_t)(px / 8);
          for (int c = 0; c < 8; ++c) {
            for (int comp = 0; comp < 3; ++comp) {
              const int t = comp != 0;
              int32_t v[8];
              for (int r = 0; r < 8; ++r) v[r] = ws[comp][r * 8 + c];
              fdct_column(v, c, q[t], m[t], outs[comp] + index * 64 + c, 8);
            }
          }
        }
        for (int k = 0; png && k < n_rows; ++k) {
          const uint32_t* row = raw.data() + (size_t)(k + 1) * stride + GRID_DUAL_PAD;
          const uint32_t* up = raw.data() + (size_t)k * stride + GRID_DUAL_PAD;
          uint32_t* sums = wsums.data() + ((size_t)warp * GRID_DUAL_ROWS + k) * FILTER_COUNT;
          for (int i = 0; i < x_end - xs; ++i) {
            filter_word_scores(row[i], row[i - 1], up[i], up[i - 1], sums);
          }
        }
        if (png && last_strip) {
          memcpy(last + (size_t)xs * 4, raw.data() + (size_t)n_rows * stride + GRID_DUAL_PAD,
                 (size_t)(x_end - xs) * 4);
        }
      });
      uint32_t* cta = partial.data() + (size_t)rank * GRID_DUAL_ROWS * FILTER_COUNT;
      for (int i = 0; i < GRID_DUAL_ROWS * FILTER_COUNT; ++i) {
        cta[i] = 0u;
        for (int warp = 0; warp < warps; ++warp) {
          cta[i] += wsums[(size_t)warp * GRID_DUAL_ROWS * FILTER_COUNT + i];
        }
      }
    }
    if (!png) continue;
    std::vector<const uint32_t*> parts(sp.ctas);
    for (int rank = 0; rank < sp.ctas; ++rank) {
      parts[rank] = partial.data() + (size_t)rank * GRID_DUAL_ROWS * FILTER_COUNT;
    }
    int choice[GRID_DUAL_ROWS];
    for (int k = 0; k < n_rows; ++k) {
      choice[k] = grid_dual_choose(parts.data(), sp.ctas, k);
      types[strip * GRID_DUAL_ROWS + k] = choice[k];
    }
    for (int rank = 0; rank < sp.ctas; ++rank) {
      slices(rank, [&](int, int xs, int x_end) {
        load(row_first, n_rows, xs, x_end);
        for (int k = 0; k < n_rows; ++k) {
          const uint32_t* row = raw.data() + (size_t)(k + 1) * stride + GRID_DUAL_PAD;
          const uint32_t* up = raw.data() + (size_t)k * stride + GRID_DUAL_PAD;
          uint8_t* out = filtered + (size_t)(strip * GRID_DUAL_ROWS + k) * (size_t)w * 4;
          for (int i = 0; i < x_end - xs; ++i) {
            const uint32_t r = filter_word_residue(choice[k], row[i], row[i - 1], up[i], up[i - 1]);
            memcpy(out + (size_t)(xs + i) * 4, &r, 4);
          }
        }
      });
    }
  }
}
