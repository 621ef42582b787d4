// stitchnative — host-side native kernels for the TPU stitching framework.
//
// TPU-native equivalent of the reference's native/WASM components (SURVEY §2):
// the Rust→WASM JPEG entropy coder (jpeg-encoder-wasm) and the byte-serial
// PNG defilter hot loop (png-filter.ts:34-100). The device (XLA/Pallas) owns
// all parallel pixel math; these are the two truly sequential byte-level
// stages that belong on the host: PNG scanline defiltering (a 2D recurrence)
// and JPEG Huffman bit packing (a serial bitstream).
//
// Build: g++ -O3 -march=native -shared -fPIC (see build.py). ctypes ABI.

#include <cstdint>
#include <cstring>
#include <cstdlib>

extern "C" {

// ---------------------------------------------------------------------------
// PNG defilter: undo None/Sub/Up/Average/Paeth over a band of rows.
// rows: h * rowbytes filtered bytes (modified in place to raw bytes).
// filter_types: h bytes. prev_row: rowbytes bytes or nullptr.
// Returns 0 on success, -1 on unknown filter type.
// ---------------------------------------------------------------------------

static inline uint8_t paeth(uint8_t a, uint8_t b, uint8_t c) {
    int p = (int)a + (int)b - (int)c;
    int pa = abs(p - (int)a);
    int pb = abs(p - (int)b);
    int pc = abs(p - (int)c);
    if (pa <= pb && pa <= pc) return a;
    if (pb <= pc) return b;
    return c;
}

// ---------------------------------------------------------------------------
// SIMD per-row defilter cores for the 4- and 8-byte-per-pixel layouts
// (RGBA8 / RGBA16 — the framework's canvas formats). The recurrences are
// serial across pixels but parallel across the bpp channel lanes: one SSE2
// step per pixel (libpng uses the same shape for its intrinsics filters).
// ---------------------------------------------------------------------------

#ifdef __SSE2__
#include <emmintrin.h>

static inline __m128i load4(const uint8_t* p) {
    int32_t w;
    memcpy(&w, p, 4);
    return _mm_cvtsi32_si128(w);
}
static inline void store4(uint8_t* p, __m128i v) {
    int32_t w = _mm_cvtsi128_si32(v);
    memcpy(p, &w, 4);
}

// Sub: cur[i] = in[i] + cur[i-bpp]; one paddb per pixel, bpp = 4 or 8.
static inline void defilter_sub_simd(uint8_t* cur, const uint8_t* in,
                                     int64_t rowbytes, int bpp) {
    __m128i a = _mm_setzero_si128();
    int64_t i = 0;
    if (bpp == 4) {
        for (; i + 4 <= rowbytes; i += 4) {
            __m128i x = load4(in + i);
            a = _mm_add_epi8(x, a);
            store4(cur + i, a);
        }
    } else {  // bpp == 8
        for (; i + 8 <= rowbytes; i += 8) {
            __m128i x = _mm_loadl_epi64((const __m128i*)(in + i));
            a = _mm_add_epi8(x, a);
            _mm_storel_epi64((__m128i*)(cur + i), a);
        }
    }
    for (; i < rowbytes; ++i)
        cur[i] = (uint8_t)(in[i] + (i >= bpp ? cur[i - bpp] : 0));
}

// Average: cur[i] = in[i] + (cur[i-bpp] + prev[i]) >> 1 (floor).
// _mm_avg_epu8 rounds up; subtract (a ^ b) & 1 to get the floor average.
static inline void defilter_avg_simd(uint8_t* cur, const uint8_t* in,
                                     const uint8_t* prev, int64_t rowbytes,
                                     int bpp) {
    const __m128i one = _mm_set1_epi8(1);
    __m128i a = _mm_setzero_si128();
    int64_t i = 0;
    if (bpp == 4) {
        for (; i + 4 <= rowbytes; i += 4) {
            __m128i x = load4(in + i);
            __m128i b = load4(prev + i);
            __m128i av = _mm_sub_epi8(
                _mm_avg_epu8(a, b),
                _mm_and_si128(_mm_xor_si128(a, b), one));
            a = _mm_add_epi8(x, av);
            store4(cur + i, a);
        }
    } else {
        for (; i + 8 <= rowbytes; i += 8) {
            __m128i x = _mm_loadl_epi64((const __m128i*)(in + i));
            __m128i b = _mm_loadl_epi64((const __m128i*)(prev + i));
            __m128i av = _mm_sub_epi8(
                _mm_avg_epu8(a, b),
                _mm_and_si128(_mm_xor_si128(a, b), one));
            a = _mm_add_epi8(x, av);
            _mm_storel_epi64((__m128i*)(cur + i), a);
        }
    }
    for (; i < rowbytes; ++i) {
        uint8_t ap = i >= bpp ? cur[i - bpp] : 0;
        cur[i] = (uint8_t)(in[i] + (uint8_t)(((int)ap + (int)prev[i]) >> 1));
    }
}

// Paeth in 16-bit lanes: pa=|b-c|, pb=|a-c|, pc=|pa+pb| with the standard
// nearest-of-three select, then cur = in + predictor.
static inline void defilter_paeth_simd(uint8_t* cur, const uint8_t* in,
                                       const uint8_t* prev, int64_t rowbytes,
                                       int bpp) {
    const __m128i zero = _mm_setzero_si128();
    __m128i a16 = zero;  // left pixel, 16-bit lanes
    __m128i c16 = zero;  // up-left pixel
    int64_t i = 0;
    for (; i + bpp <= rowbytes; i += bpp) {
        __m128i x, b;
        if (bpp == 4) {
            x = load4(in + i);
            b = load4(prev + i);
        } else {
            x = _mm_loadl_epi64((const __m128i*)(in + i));
            b = _mm_loadl_epi64((const __m128i*)(prev + i));
        }
        __m128i b16 = _mm_unpacklo_epi8(b, zero);
        __m128i pa = _mm_sub_epi16(b16, c16);               // p - a
        __m128i pb = _mm_sub_epi16(a16, c16);               // p - b
        __m128i pc = _mm_add_epi16(pa, pb);                 // p - c
        pa = _mm_max_epi16(pa, _mm_sub_epi16(zero, pa));    // |..|
        pb = _mm_max_epi16(pb, _mm_sub_epi16(zero, pb));
        pc = _mm_max_epi16(pc, _mm_sub_epi16(zero, pc));
        __m128i use_b = _mm_andnot_si128(
            _mm_cmpgt_epi16(pb, pc), _mm_cmpgt_epi16(pa, pb));
        __m128i use_c = _mm_and_si128(
            _mm_cmpgt_epi16(pa, pc), _mm_cmpgt_epi16(pb, pc));
        __m128i pred = _mm_or_si128(
            _mm_and_si128(use_c, c16),
            _mm_andnot_si128(
                use_c, _mm_or_si128(_mm_and_si128(use_b, b16),
                                    _mm_andnot_si128(use_b, a16))));
        __m128i x16 = _mm_unpacklo_epi8(x, zero);
        a16 = _mm_and_si128(_mm_add_epi16(x16, pred), _mm_set1_epi16(0xFF));
        c16 = b16;
        __m128i packed = _mm_packus_epi16(a16, a16);
        if (bpp == 4)
            store4(cur + i, packed);
        else
            _mm_storel_epi64((__m128i*)(cur + i), packed);
    }
    for (; i < rowbytes; ++i) {
        uint8_t ap = i >= bpp ? cur[i - bpp] : 0;
        uint8_t cp = i >= bpp ? prev[i - bpp] : 0;
        cur[i] = (uint8_t)(in[i] + paeth(ap, prev[i], cp));
    }
}

#define STITCH_HAVE_SIMD_DEFILTER 1
#else
#define STITCH_HAVE_SIMD_DEFILTER 0
#endif

// Defilter one scanline from `in` (filtered) into `cur` (raw). `prev` is
// the previous raw row or null. cur != in required for the SIMD paths
// (callers pass distinct buffers); the scalar tails handle cur == in + k
// aliasing only in the in-place band variant below, which keeps its own
// loops for Sub/Up where in == cur.
static int defilter_row_into(uint8_t* cur, const uint8_t* in,
                             const uint8_t* prev, int64_t rowbytes, int bpp,
                             uint8_t ft) {
    switch (ft) {
        case 0:
            if (cur != in) memcpy(cur, in, (size_t)rowbytes);
            return 0;
        case 1:
#if STITCH_HAVE_SIMD_DEFILTER
            if (bpp == 4 || bpp == 8) {
                defilter_sub_simd(cur, in, rowbytes, bpp);
                return 0;
            }
#endif
            for (int64_t i = 0; i < bpp && i < rowbytes; ++i) cur[i] = in[i];
            for (int64_t i = bpp; i < rowbytes; ++i)
                cur[i] = (uint8_t)(in[i] + cur[i - bpp]);
            return 0;
        case 2:
            if (prev)
                for (int64_t i = 0; i < rowbytes; ++i)
                    cur[i] = (uint8_t)(in[i] + prev[i]);
            else
                memcpy(cur, in, (size_t)rowbytes);
            return 0;
        case 3:
            if (prev) {
#if STITCH_HAVE_SIMD_DEFILTER
                if (bpp == 4 || bpp == 8) {
                    defilter_avg_simd(cur, in, prev, rowbytes, bpp);
                    return 0;
                }
#endif
                for (int64_t i = 0; i < bpp && i < rowbytes; ++i)
                    cur[i] = (uint8_t)(in[i] + (prev[i] >> 1));
                for (int64_t i = bpp; i < rowbytes; ++i)
                    cur[i] = (uint8_t)(in[i] +
                                       (((int)cur[i - bpp] + (int)prev[i]) >> 1));
            } else {
                for (int64_t i = 0; i < bpp && i < rowbytes; ++i) cur[i] = in[i];
                for (int64_t i = bpp; i < rowbytes; ++i)
                    cur[i] = (uint8_t)(in[i] + (cur[i - bpp] >> 1));
            }
            return 0;
        case 4:
            if (prev) {
#if STITCH_HAVE_SIMD_DEFILTER
                if (bpp == 4 || bpp == 8) {
                    defilter_paeth_simd(cur, in, prev, rowbytes, bpp);
                    return 0;
                }
#endif
                for (int64_t i = 0; i < bpp && i < rowbytes; ++i)
                    cur[i] = (uint8_t)(in[i] + prev[i]);
                for (int64_t i = bpp; i < rowbytes; ++i)
                    cur[i] = (uint8_t)(in[i] + paeth(cur[i - bpp], prev[i],
                                                     prev[i - bpp]));
            } else {
#if STITCH_HAVE_SIMD_DEFILTER
                if (bpp == 4 || bpp == 8) {  // paeth degenerates to sub
                    defilter_sub_simd(cur, in, rowbytes, bpp);
                    return 0;
                }
#endif
                for (int64_t i = 0; i < bpp && i < rowbytes; ++i) cur[i] = in[i];
                for (int64_t i = bpp; i < rowbytes; ++i)
                    cur[i] = (uint8_t)(in[i] + cur[i - bpp]);
            }
            return 0;
        default:
            return -1;
    }
}

// In-place variant: rows holds filtered bytes, becomes raw bytes.
// defilter_row_into is in-place-safe: every path reads in[i] before
// writing cur[i] and carries the left pixel in a register.
int png_defilter_band(uint8_t* rows, const uint8_t* filter_types,
                      int64_t h, int64_t rowbytes, int bpp,
                      const uint8_t* prev_row) {
    const uint8_t* prev = prev_row;  // may be null for first band
    for (int64_t y = 0; y < h; ++y) {
        uint8_t* cur = rows + y * rowbytes;
        if (defilter_row_into(cur, cur, prev, rowbytes, bpp, filter_types[y]))
            return -1;
        prev = cur;
    }
    return 0;
}

// Strided-input variant: reads filter byte + filtered bytes directly from
// the decoder's (1+rowbytes)-stride scanline units (no contiguous copy),
// writes raw bytes into a separate contiguous output.
int png_defilter_units(const uint8_t* units, int64_t unit_stride,
                       int64_t h, int64_t rowbytes, int bpp,
                       const uint8_t* prev_row, uint8_t* out) {
    const uint8_t* prev = prev_row;
    for (int64_t y = 0; y < h; ++y) {
        const uint8_t* src = units + y * unit_stride;
        uint8_t* cur = out + y * rowbytes;
        if (defilter_row_into(cur, src + 1, prev, rowbytes, bpp, src[0]))
            return -1;
        prev = cur;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// JPEG Huffman entropy coding of interleaved 4:4:4 MCUs.
//
// Inputs: three (n_blocks, 64) int32 arrays of quantized coefficients in
// natural (row-major) order, standard code tables, DC predictors and the
// bit-reservoir carry. Output: stuffed entropy bytes.
//
// State (prev_dc[3], bit buffer) lives in the caller so strips stream.
// Returns number of bytes written to out (capacity must be generous:
// worst case ~ n_blocks * 3 * 256 bytes).
// ---------------------------------------------------------------------------

typedef struct {
    uint32_t dc_code[16];
    uint8_t dc_len[16];
    uint32_t ac_code[256];
    uint8_t ac_len[256];
} HuffTable;

typedef struct {
    uint64_t bits;     // bit reservoir, MSB-aligned within count
    int count;         // number of valid bits in reservoir
    int32_t prev_dc[3];
} EntropyState;

static const int kZigzag[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

static inline int bit_size(int v) {
    unsigned s = (unsigned)(v >> 31);
    unsigned uv = ((unsigned)v ^ s) - s;  // branchless |v|
    return uv ? 32 - __builtin_clz(uv) : 0;
}

// Emit whole bytes from the bit buffer one at a time (stuffing-aware).
static inline void drain_bytes(EntropyState* st, uint8_t** outp) {
    while (st->count >= 8) {
        uint8_t byte = (uint8_t)(st->bits >> (st->count - 8));
        st->count -= 8;
        *(*outp)++ = byte;
        if (byte == 0xFF) *(*outp)++ = 0x00;  // stuffing
    }
}

static inline void put_bits(EntropyState* st, uint8_t** outp, uint32_t code,
                            int len) {
    // Deferred flushing: keep up to 57 bits buffered; when >= 32 are
    // pending, emit 4 bytes at once. 0xFF bytes (needing 0x00 stuffing) are
    // detected with a SWAR zero-byte test on the complemented word — the
    // fast path is a plain big-endian store (0xFF bytes are ~1/256 of
    // entropy output).
    if (st->count >= 32) {
        uint32_t chunk = (uint32_t)(st->bits >> (st->count - 32));
        uint32_t t = ~chunk;
        if ((t - 0x01010101u) & ~t & 0x80808080u) {
            drain_bytes(st, outp);  // an 0xFF byte somewhere: stuff per byte
        } else {
            (*outp)[0] = (uint8_t)(chunk >> 24);
            (*outp)[1] = (uint8_t)(chunk >> 16);
            (*outp)[2] = (uint8_t)(chunk >> 8);
            (*outp)[3] = (uint8_t)chunk;
            *outp += 4;
            st->count -= 32;
            st->bits &= (st->count ? ((1ull << st->count) - 1ull) : 0ull);
        }
    }
    // 64-bit mask: fused code+magnitude emissions can reach len == 32.
    st->bits = (st->bits << len) | ((uint64_t)code & ((1ull << len) - 1ull));
    st->count += len;
}

#ifdef __AVX2__
#include <immintrin.h>
// Bitmask of nonzero int16 lanes in zz[0..63] (bit k set iff zz[k] != 0).
static inline uint64_t nonzero_mask64(const int16_t* zz) {
    const __m256i zero = _mm256_setzero_si256();
    uint64_t m = 0;
    for (int g = 0; g < 4; ++g) {
        __m256i a = _mm256_loadu_si256((const __m256i*)(zz + g * 16));
        __m256i eq = _mm256_cmpeq_epi16(a, zero);
        // Two bytes per lane; take one bit per int16 via pack+movemask.
        __m256i packed = _mm256_packs_epi16(eq, zero);  // lanes interleave
        packed = _mm256_permute4x64_epi64(packed, 0xD8);
        uint32_t z16 = (uint32_t)_mm256_movemask_epi8(packed) & 0xFFFFu;
        m |= ((uint64_t)(~z16 & 0xFFFFu)) << (g * 16);
    }
    return m;
}
#else
static inline uint64_t nonzero_mask64(const int16_t* zz) {
    uint64_t m = 0;
    for (int k = 0; k < 64; ++k) m |= (uint64_t)(zz[k] != 0) << k;
    return m;
}
#endif

// natural position -> zigzag index (inverse of kZigzag), built on first use
static uint8_t kNatToZig[64];
static int kNatToZigInit = 0;

static void encode_block(EntropyState* st, uint8_t** outp, const int16_t* blk,
                         const HuffTable* t, int comp) {
#if defined(__AVX512BW__)
    // vpermi2w materializes all 64 coefficients in ZIGZAG order in two ops
    // (the 6-bit selector is exactly kZigzag[k] across the two source
    // registers), and test_epi16_mask yields the nonzero mask directly in
    // zigzag order — no per-set-bit natural->zigzag permute loop at all.
    // The 128-byte zz staging store stays in L1 and replaces the
    // blk[kZigzag[k]] indirection in the emission loop.
    static const int16_t kZzIdx[64] = {
        0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
        12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
        35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
        58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
    __m512i a = _mm512_loadu_si512((const void*)blk);
    __m512i b = _mm512_loadu_si512((const void*)(blk + 32));
    __m512i z0 = _mm512_permutex2var_epi16(
        a, _mm512_loadu_si512((const void*)kZzIdx), b);
    __m512i z1 = _mm512_permutex2var_epi16(
        a, _mm512_loadu_si512((const void*)(kZzIdx + 32)), b);
    uint64_t m = (((uint64_t)_mm512_test_epi16_mask(z0, z0)) |
                  ((uint64_t)_mm512_test_epi16_mask(z1, z1) << 32)) &
                 ~1ull;  // zigzag-order AC mask
    alignas(64) int16_t zz[64];
    _mm512_store_si512((void*)zz, z0);
    _mm512_store_si512((void*)(zz + 32), z1);
    // Vectorized size/magnitude precompute: size = 32 - lzcnt32(|v|)
    // (0 for v==0), vb = (v + (sign & (2^size-1))) & (2^size-1) — the AC
    // loop below then only does ctz/run/table/put.
    alignas(64) uint16_t zz_vb[64];
    alignas(64) uint8_t zz_sz[64];
    {
        const __m512i one32 = _mm512_set1_epi32(1);
        const __m512i c32 = _mm512_set1_epi32(32);
        for (int g = 0; g < 2; ++g) {
            __m512i z = g ? z1 : z0;
            for (int h2 = 0; h2 < 2; ++h2) {
                __m256i half = h2 ? _mm512_extracti64x4_epi64(z, 1)
                                  : _mm512_castsi512_si256(z);
                __m512i v32 = _mm512_cvtepi16_epi32(half);
                __m512i av = _mm512_abs_epi32(v32);
                __m512i sz = _mm512_sub_epi32(c32, _mm512_lzcnt_epi32(av));
                __m512i msk = _mm512_sub_epi32(_mm512_sllv_epi32(one32, sz),
                                               one32);
                __m512i sgn = _mm512_srai_epi32(v32, 31);
                __m512i vb = _mm512_and_si512(
                    _mm512_add_epi32(v32, _mm512_and_si512(sgn, msk)), msk);
                // pack vb -> uint16, sz -> uint8 (values < 2^16 / < 16)
                _mm256_store_si256((__m256i*)(zz_vb + g * 32 + h2 * 16),
                                   _mm512_cvtepi32_epi16(vb));
                _mm_store_si128((__m128i*)(zz_sz + g * 32 + h2 * 16),
                                _mm512_cvtepi32_epi8(sz));
            }
        }
    }
#define STITCH_ZZ_COEF(k) zz[k]
#define STITCH_ZZ_FAST 1
#else
    // Nonzero bitmask in NATURAL order (one AVX2 sweep), permuted bitwise
    // into zigzag order — only the ~dozen set bits pay the permutation and
    // only their coefficients are ever loaded. The old dense zigzag gather
    // moved all 64 int16 per block regardless of sparsity.
    if (!kNatToZigInit) {
        for (int k = 0; k < 64; ++k) kNatToZig[kZigzag[k]] = (uint8_t)k;
        kNatToZigInit = 1;
    }
    uint64_t m_nat = nonzero_mask64(blk) & ~1ull;
    uint64_t m = 0;  // zigzag-order AC mask
    while (m_nat) {
        int k = __builtin_ctzll(m_nat);
        m_nat &= m_nat - 1;
        m |= 1ull << kNatToZig[k];
    }
#define STITCH_ZZ_COEF(k) blk[kZigzag[k]]
#endif

    int32_t dc = blk[0];
    int32_t diff = dc - st->prev_dc[comp];
    st->prev_dc[comp] = dc;
    int s = bit_size(diff);
    {
        // Branchless fused code+magnitude: for s==0 the expression
        // degenerates to the bare code (v masks to 0), and the sign
        // adjustment uses an arithmetic-shift mask instead of a
        // data-dependent branch.
        uint32_t sign = (uint32_t)(diff >> 31);
        uint32_t v = ((uint32_t)diff + (sign & (((uint32_t)1 << s) - 1u))) &
                     (((uint32_t)1 << s) - 1u);
        put_bits(st, outp, ((uint32_t)t->dc_code[s] << s) | v, t->dc_len[s] + s);
    }

    int prev = 0;
    int last_nz = 0;
    while (m) {
        int k = __builtin_ctzll(m);
        m &= m - 1;
        int run = k - prev - 1;
        while (run > 15) {
            put_bits(st, outp, t->ac_code[0xF0], t->ac_len[0xF0]);
            run -= 16;
        }
#ifdef STITCH_ZZ_FAST
        int size = zz_sz[k];
        uint32_t vb_pre = zz_vb[k];
        int sym = (run << 4) | size;
        put_bits(st, outp, ((uint32_t)t->ac_code[sym] << size) | vb_pre,
                 t->ac_len[sym] + size);
        prev = k;
        last_nz = k;
        continue;
#else
        int32_t v = STITCH_ZZ_COEF(k);
        int size = bit_size(v);
        int sym = (run << 4) | size;
        // Branchless sign adjustment: the ternary form compiled to a
        // data-dependent branch that mispredicted ~50/50 on noise-like
        // coefficients — measured +30-58% on the whole entropy stage
        // (round-4 interleaved A/B, bytes identical).
        uint32_t sign_ = (uint32_t)(v >> 31);
        uint32_t vb = ((uint32_t)v + (sign_ & (((uint32_t)1 << size) - 1u))) &
                      (((uint32_t)1 << size) - 1u);
        // Fused code+magnitude (max 16+16=32 bits; put_bits flushes to
        // count<32 before appending, so the 64-bit buffer never overflows).
        put_bits(st, outp, ((uint32_t)t->ac_code[sym] << size) | vb,
                 t->ac_len[sym] + size);
        prev = k;
        last_nz = k;
#endif
    }
    if (last_nz != 63) put_bits(st, outp, t->ac_code[0x00], t->ac_len[0x00]);
#undef STITCH_ZZ_COEF
#ifdef STITCH_ZZ_FAST
#undef STITCH_ZZ_FAST
#endif
}

// Structural worst case per encoded block: DC (16-bit code + 17 magnitude
// bits) + 63 AC x (16-bit code + 16 magnitude bits) = 2049 bits ~ 257 bytes,
// doubled by 0xFF stuffing = 514 bytes (+ <8 carried bytes). The per-MCU
// headroom check below uses this bound so put_bits stays branch-light.
static const int64_t kMaxBlockBytes = 528;

int64_t jpeg_entropy_encode_444(const int16_t* y_blocks,
                                const int16_t* cb_blocks,
                                const int16_t* cr_blocks, int64_t n_mcus,
                                const HuffTable* luma, const HuffTable* chroma,
                                EntropyState* state, uint8_t* out,
                                int64_t capacity) {
    uint8_t* p = out;
    const uint8_t* end = out + capacity;
    for (int64_t m = 0; m < n_mcus; ++m) {
        if (end - p < 3 * kMaxBlockBytes) return -1;  // capacity exhausted
        encode_block(state, &p, y_blocks + m * 64, luma, 0);
        encode_block(state, &p, cb_blocks + m * 64, chroma, 1);
        encode_block(state, &p, cr_blocks + m * 64, chroma, 2);
    }
    return (int64_t)(p - out);
}

// 4:2:0 MCU: 4 Y blocks + 1 Cb + 1 Cr.
int64_t jpeg_entropy_encode_420(const int16_t* y_blocks,
                                const int16_t* cb_blocks,
                                const int16_t* cr_blocks, int64_t n_mcus,
                                const HuffTable* luma, const HuffTable* chroma,
                                EntropyState* state, uint8_t* out,
                                int64_t capacity) {
    uint8_t* p = out;
    const uint8_t* end = out + capacity;
    for (int64_t m = 0; m < n_mcus; ++m) {
        if (end - p < 6 * kMaxBlockBytes) return -1;  // capacity exhausted
        for (int i = 0; i < 4; ++i)
            encode_block(state, &p, y_blocks + (m * 4 + i) * 64, luma, 0);
        encode_block(state, &p, cb_blocks + m * 64, chroma, 1);
        encode_block(state, &p, cr_blocks + m * 64, chroma, 2);
    }
    return (int64_t)(p - out);
}

// ---------------------------------------------------------------------------
// Porter-Duff "over" alpha compositing (straight alpha), float64 math
// matching the reference JS expression order exactly (pixel-ops.ts:646-744):
// copy when srcAlpha >= 0.9999, skip when <= 0.0001, Math.round == floor+0.5.
// Identical results to the numpy float64 oracle (ops/pixel.composite_band).
// ---------------------------------------------------------------------------

// fp-contract off: FMA fusion would change the float64 results vs the
// numpy oracle (and the reference's JS), which computes mul/add separately.
__attribute__((optimize("fp-contract=off")))
void composite_rgba8(uint8_t* dest, const uint8_t* src, int64_t n_pixels) {
    for (int64_t i = 0; i < n_pixels; ++i) {
        const uint8_t* s = src + i * 4;
        uint8_t* d = dest + i * 4;
        double sa = (double)s[3] / 255.0;
        if (sa >= 0.9999) {
            d[0] = s[0]; d[1] = s[1]; d[2] = s[2]; d[3] = s[3];
        } else if (sa > 0.0001) {
            double da = (double)d[3] / 255.0;
            double oa = sa + da * (1.0 - sa);
            if (oa > 0.0001) {
                for (int c = 0; c < 3; ++c) {
                    double blended =
                        ((double)s[c] * sa + (double)d[c] * da * (1.0 - sa)) / oa;
                    if (blended > 255.0) blended = 255.0;
                    if (blended < 0.0) blended = 0.0;
                    d[c] = (uint8_t)((int)(blended + 0.5));
                }
                d[3] = (uint8_t)((int)(oa * 255.0 + 0.5));
            }
        }
    }
}

__attribute__((optimize("fp-contract=off")))
void composite_rgba16(uint16_t* dest, const uint16_t* src, int64_t n_pixels) {
    for (int64_t i = 0; i < n_pixels; ++i) {
        const uint16_t* s = src + i * 4;
        uint16_t* d = dest + i * 4;
        double sa = (double)s[3] / 65535.0;
        if (sa >= 0.9999) {
            d[0] = s[0]; d[1] = s[1]; d[2] = s[2]; d[3] = s[3];
        } else if (sa > 0.0001) {
            double da = (double)d[3] / 65535.0;
            double oa = sa + da * (1.0 - sa);
            if (oa > 0.0001) {
                for (int c = 0; c < 3; ++c) {
                    double blended =
                        ((double)s[c] * sa + (double)d[c] * da * (1.0 - sa)) / oa;
                    if (blended > 65535.0) blended = 65535.0;
                    if (blended < 0.0) blended = 0.0;
                    d[c] = (uint16_t)((int)(blended + 0.5));
                }
                d[3] = (uint16_t)((int)(oa * 65535.0 + 0.5));
            }
        }
    }
}

// ---------------------------------------------------------------------------
// PNG filter selection over a band (encode side).
//
// For every row: compute all 5 filter candidates, score by sum of
// |signed byte|, pick the first minimum (None,Sub,Up,Average,Paeth order —
// the reference's strict-< rule, png-filter.ts:154-180), write the chosen
// filtered bytes. prev rows come from the band itself (raw input), so rows
// are independent; this is the host tier of the device program
// (ops/device.filter_select_trace).
// ---------------------------------------------------------------------------

static inline int absi8(uint8_t v) {
    int s = (int)(int8_t)v;
    return s < 0 ? -s : s;
}

#ifdef __AVX2__
// Vectorized 5-filter scoring for one scanline region [i0, i1) where all
// of x/a/b/c are plain loads (i >= bpp). The scalar loop's per-byte Paeth
// has two data-dependent branches that both mispredict on noisy content
// AND block autovectorization; here the predictor is the standard
// branchless 16-bit select and every |signed| is min_epu8(v, 0-v) folded
// into SAD accumulation.
static void score_filters_avx2(const uint8_t* cur, const uint8_t* up,
                               int64_t i0, int64_t i1, int bpp,
                               long sums[5]) {
    const __m256i zero = _mm256_setzero_si256();
    const __m256i one8 = _mm256_set1_epi8(1);
    const __m256i one16 = _mm256_set1_epi16(1);
    __m256i acc0 = zero, acc1 = zero, acc2 = zero, acc3 = zero;
    __m256i acc4 = zero;  // 32-bit lanes (madd of 16-bit |residual|)
    int64_t i = i0;
    for (; i + 32 <= i1; i += 32) {
        __m256i x = _mm256_loadu_si256((const __m256i*)(cur + i));
        __m256i a = _mm256_loadu_si256((const __m256i*)(cur + i - bpp));
        __m256i b = up ? _mm256_loadu_si256((const __m256i*)(up + i)) : zero;
        __m256i c = up ? _mm256_loadu_si256((const __m256i*)(up + i - bpp))
                       : zero;
#define STITCH_ABS8(v) _mm256_min_epu8((v), _mm256_sub_epi8(zero, (v)))
        acc0 = _mm256_add_epi64(acc0, _mm256_sad_epu8(STITCH_ABS8(x), zero));
        __m256i r1 = _mm256_sub_epi8(x, a);
        acc1 = _mm256_add_epi64(acc1, _mm256_sad_epu8(STITCH_ABS8(r1), zero));
        __m256i r2 = _mm256_sub_epi8(x, b);
        acc2 = _mm256_add_epi64(acc2, _mm256_sad_epu8(STITCH_ABS8(r2), zero));
        __m256i avg = _mm256_sub_epi8(
            _mm256_avg_epu8(a, b),
            _mm256_and_si256(_mm256_xor_si256(a, b), one8));
        __m256i r3 = _mm256_sub_epi8(x, avg);
        acc3 = _mm256_add_epi64(acc3, _mm256_sad_epu8(STITCH_ABS8(r3), zero));
#undef STITCH_ABS8
        // Paeth in 16-bit halves: pa=|b-c|, pb=|a-c|, pc=|a+b-2c|;
        // pred = a if pa<=pb && pa<=pc else b if pb<=pc else c.
        for (int half = 0; half < 2; ++half) {
            __m128i x8 = half ? _mm256_extracti128_si256(x, 1)
                              : _mm256_castsi256_si128(x);
            __m128i a8 = half ? _mm256_extracti128_si256(a, 1)
                              : _mm256_castsi256_si128(a);
            __m128i b8 = half ? _mm256_extracti128_si256(b, 1)
                              : _mm256_castsi256_si128(b);
            __m128i c8 = half ? _mm256_extracti128_si256(c, 1)
                              : _mm256_castsi256_si128(c);
            __m256i x16 = _mm256_cvtepu8_epi16(x8);
            __m256i a16 = _mm256_cvtepu8_epi16(a8);
            __m256i b16 = _mm256_cvtepu8_epi16(b8);
            __m256i c16 = _mm256_cvtepu8_epi16(c8);
            __m256i pa = _mm256_abs_epi16(_mm256_sub_epi16(b16, c16));
            __m256i pb = _mm256_abs_epi16(_mm256_sub_epi16(a16, c16));
            __m256i pc = _mm256_abs_epi16(_mm256_sub_epi16(
                _mm256_add_epi16(a16, b16),
                _mm256_add_epi16(c16, c16)));
            __m256i nota = _mm256_or_si256(_mm256_cmpgt_epi16(pa, pb),
                                           _mm256_cmpgt_epi16(pa, pc));
            __m256i selb = _mm256_cmpgt_epi16(pb, pc);  // true -> c
            __m256i pred = _mm256_blendv_epi8(
                a16, _mm256_blendv_epi8(b16, c16, selb), nota);
            // Match the scalar definition |int8((x - pred) mod 256)|:
            // take the wrapped byte then min(v, 256 - v).
            __m256i r8 = _mm256_and_si256(_mm256_sub_epi16(x16, pred),
                                          _mm256_set1_epi16(0xFF));
            __m256i r4 = _mm256_min_epu16(
                r8, _mm256_sub_epi16(_mm256_set1_epi16(256), r8));
            acc4 = _mm256_add_epi32(acc4, _mm256_madd_epi16(r4, one16));
        }
    }
    alignas(32) long long l4[4];
    _mm256_store_si256((__m256i*)l4, acc0);
    sums[0] += (long)(l4[0] + l4[1] + l4[2] + l4[3]);
    _mm256_store_si256((__m256i*)l4, acc1);
    sums[1] += (long)(l4[0] + l4[1] + l4[2] + l4[3]);
    _mm256_store_si256((__m256i*)l4, acc2);
    sums[2] += (long)(l4[0] + l4[1] + l4[2] + l4[3]);
    _mm256_store_si256((__m256i*)l4, acc3);
    sums[3] += (long)(l4[0] + l4[1] + l4[2] + l4[3]);
    alignas(32) int32_t i4[8];
    _mm256_store_si256((__m256i*)i4, acc4);
    sums[4] += (long)i4[0] + i4[1] + i4[2] + i4[3] + i4[4] + i4[5] + i4[6] +
               i4[7];
    // Scalar tail for the last (i1 - i) % 32 bytes.
    for (; i < i1; ++i) {
        uint8_t x = cur[i];
        uint8_t a = cur[i - bpp];
        uint8_t b = up ? up[i] : 0;
        uint8_t c = up ? up[i - bpp] : 0;
        sums[0] += absi8(x);
        sums[1] += absi8((uint8_t)(x - a));
        sums[2] += absi8((uint8_t)(x - b));
        sums[3] += absi8((uint8_t)(x - (uint8_t)(((int)a + (int)b) >> 1)));
        sums[4] += absi8((uint8_t)(x - paeth(a, b, c)));
    }
}
#endif

void png_filter_select_band(const uint8_t* rows, const uint8_t* prev_row,
                            int64_t h, int64_t n, int bpp,
                            uint8_t* out_types, uint8_t* out_rows) {
    for (int64_t y = 0; y < h; ++y) {
        const uint8_t* cur = rows + y * n;
        const uint8_t* up = y > 0 ? rows + (y - 1) * n : prev_row;  // may be null
        long sums[5] = {0, 0, 0, 0, 0};
        int64_t i_start = 0;
#ifdef __AVX2__
        if (n - bpp >= 64) {
            // Prologue (i < bpp: left/up-left are zero) stays scalar.
            for (int64_t i = 0; i < bpp; ++i) {
                uint8_t x = cur[i];
                uint8_t b = up ? up[i] : 0;
                sums[0] += absi8(x);
                sums[1] += absi8(x);
                sums[2] += absi8((uint8_t)(x - b));
                sums[3] += absi8((uint8_t)(x - (uint8_t)(((int)b) >> 1)));
                sums[4] += absi8((uint8_t)(x - paeth(0, b, 0)));
            }
            score_filters_avx2(cur, up, bpp, n, bpp, sums);
            i_start = n;
        }
#endif
        for (int64_t i = i_start; i < n; ++i) {
            uint8_t x = cur[i];
            uint8_t a = i >= bpp ? cur[i - bpp] : 0;           // left
            uint8_t b = up ? up[i] : 0;                        // up
            uint8_t c = (up && i >= bpp) ? up[i - bpp] : 0;    // up-left
            sums[0] += absi8(x);
            sums[1] += absi8((uint8_t)(x - a));
            sums[2] += absi8((uint8_t)(x - b));
            sums[3] += absi8((uint8_t)(x - (uint8_t)(((int)a + (int)b) >> 1)));
            sums[4] += absi8((uint8_t)(x - paeth(a, b, c)));
        }
        int best = 0;
        for (int f = 1; f < 5; ++f)
            if (sums[f] < sums[best]) best = f;
        out_types[y] = (uint8_t)best;
        uint8_t* o = out_rows + y * n;
        switch (best) {
            case 0:
                memcpy(o, cur, (size_t)n);
                break;
            case 1:
                for (int64_t i = 0; i < n; ++i)
                    o[i] = (uint8_t)(cur[i] - (i >= bpp ? cur[i - bpp] : 0));
                break;
            case 2:
                for (int64_t i = 0; i < n; ++i)
                    o[i] = (uint8_t)(cur[i] - (up ? up[i] : 0));
                break;
            case 3:
                for (int64_t i = 0; i < n; ++i) {
                    uint8_t a = i >= bpp ? cur[i - bpp] : 0;
                    uint8_t b = up ? up[i] : 0;
                    o[i] = (uint8_t)(cur[i] - (uint8_t)(((int)a + (int)b) >> 1));
                }
                break;
            case 4: {
                int64_t i = 0;
                for (; i < bpp && i < n; ++i)
                    o[i] = (uint8_t)(cur[i] - paeth(0, up ? up[i] : 0, 0));
#ifdef __AVX2__
                // Same branchless 16-bit predictor as the scorer; the
                // wrapped residual bytes pack straight back (values are
                // already in [0, 255], so packus is exact).
                const __m256i zero = _mm256_setzero_si256();
                const __m256i m255 = _mm256_set1_epi16(0xFF);
                for (; i + 32 <= n; i += 32) {
                    __m256i x = _mm256_loadu_si256((const __m256i*)(cur + i));
                    __m256i a = _mm256_loadu_si256(
                        (const __m256i*)(cur + i - bpp));
                    __m256i b = up ? _mm256_loadu_si256(
                                         (const __m256i*)(up + i))
                                   : zero;
                    __m256i c = up ? _mm256_loadu_si256(
                                         (const __m256i*)(up + i - bpp))
                                   : zero;
                    __m256i res[2];
                    for (int half = 0; half < 2; ++half) {
                        __m128i x8 = half ? _mm256_extracti128_si256(x, 1)
                                          : _mm256_castsi256_si128(x);
                        __m128i a8 = half ? _mm256_extracti128_si256(a, 1)
                                          : _mm256_castsi256_si128(a);
                        __m128i b8 = half ? _mm256_extracti128_si256(b, 1)
                                          : _mm256_castsi256_si128(b);
                        __m128i c8 = half ? _mm256_extracti128_si256(c, 1)
                                          : _mm256_castsi256_si128(c);
                        __m256i x16 = _mm256_cvtepu8_epi16(x8);
                        __m256i a16 = _mm256_cvtepu8_epi16(a8);
                        __m256i b16 = _mm256_cvtepu8_epi16(b8);
                        __m256i c16 = _mm256_cvtepu8_epi16(c8);
                        __m256i pa =
                            _mm256_abs_epi16(_mm256_sub_epi16(b16, c16));
                        __m256i pb =
                            _mm256_abs_epi16(_mm256_sub_epi16(a16, c16));
                        __m256i pc = _mm256_abs_epi16(_mm256_sub_epi16(
                            _mm256_add_epi16(a16, b16),
                            _mm256_add_epi16(c16, c16)));
                        __m256i nota =
                            _mm256_or_si256(_mm256_cmpgt_epi16(pa, pb),
                                            _mm256_cmpgt_epi16(pa, pc));
                        __m256i selb = _mm256_cmpgt_epi16(pb, pc);
                        __m256i pred = _mm256_blendv_epi8(
                            a16, _mm256_blendv_epi8(b16, c16, selb), nota);
                        res[half] = _mm256_and_si256(
                            _mm256_sub_epi16(x16, pred), m255);
                    }
                    __m256i packed = _mm256_permute4x64_epi64(
                        _mm256_packus_epi16(res[0], res[1]), 0xD8);
                    _mm256_storeu_si256((__m256i*)(o + i), packed);
                }
#endif
                for (; i < n; ++i) {
                    uint8_t a = cur[i - bpp];
                    uint8_t b = up ? up[i] : 0;
                    uint8_t c = up ? up[i - bpp] : 0;
                    o[i] = (uint8_t)(cur[i] - paeth(a, b, c));
                }
                break;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Fused RGBA -> YCbCr -> 8x8 FDCT -> quantize over a band (4:4:4).
//
// Host fast tier of the encoder's device program (ops/jpeg_dct.py): the
// EXACT INTEGER pipeline — 16-bit fixed-point YCbCr, 13-bit fixed-point
// butterfly FDCT (T.81 Sec. A.3.3 flowgraph, jfdctint constants), and
// quantization via a single IEEE f32 division whose floor is provably
// exact. Every tier (numpy / XLA on any backend or mesh / this C++)
// computes bit-identical quantized coefficients by construction. Input
// (h, w, 4) uint8 with h % 8 == 0 and w % 8 == 0; outputs
// (h/8 * w/8, 64) int16 blocks per component in strip-major order.
// ---------------------------------------------------------------------------

#define STITCH_CONST_BITS 13
#define STITCH_PASS1_BITS 2

static inline int32_t stitch_descale(int32_t x, int n) {
    return (x + (1 << (n - 1))) >> n;  // arithmetic shift (gcc/clang)
}

// One 8-point fixed-point DCT pass over d[0..7] (stride s), matching
// ops/jpeg_dct._fdct_pass exactly. final=0: row pass; final=1: column pass.
static inline void fdct8_pass(int32_t* d, int s, int final_pass) {
    int32_t t0 = d[0 * s] + d[7 * s], t7 = d[0 * s] - d[7 * s];
    int32_t t1 = d[1 * s] + d[6 * s], t6 = d[1 * s] - d[6 * s];
    int32_t t2 = d[2 * s] + d[5 * s], t5 = d[2 * s] - d[5 * s];
    int32_t t3 = d[3 * s] + d[4 * s], t4 = d[3 * s] - d[4 * s];
    int32_t t10 = t0 + t3, t13 = t0 - t3;
    int32_t t11 = t1 + t2, t12 = t1 - t2;
    int shift;
    if (final_pass) {
        d[0 * s] = stitch_descale(t10 + t11, STITCH_PASS1_BITS);
        d[4 * s] = stitch_descale(t10 - t11, STITCH_PASS1_BITS);
        shift = STITCH_CONST_BITS + STITCH_PASS1_BITS;
    } else {
        d[0 * s] = (t10 + t11) * (1 << STITCH_PASS1_BITS);
        d[4 * s] = (t10 - t11) * (1 << STITCH_PASS1_BITS);
        shift = STITCH_CONST_BITS - STITCH_PASS1_BITS;
    }
    int32_t z1 = (t12 + t13) * 4433;
    d[2 * s] = stitch_descale(z1 + t13 * 6270, shift);
    d[6 * s] = stitch_descale(z1 - t12 * 15137, shift);
    z1 = t4 + t7;
    int32_t z2 = t5 + t6, z3 = t4 + t6, z4 = t5 + t7;
    int32_t z5 = (z3 + z4) * 9633;
    t4 *= 2446;
    t5 *= 16819;
    t6 *= 25172;
    t7 *= 12299;
    z1 *= -7373;
    z2 *= -20995;
    z3 = z3 * -16069 + z5;
    z4 = z4 * -3196 + z5;
    d[7 * s] = stitch_descale(t4 + z1 + z3, shift);
    d[5 * s] = stitch_descale(t5 + z2 + z4, shift);
    d[3 * s] = stitch_descale(t6 + z2 + z3, shift);
    d[1 * s] = stitch_descale(t7 + z1 + z4, shift);
}

static void fdct8_islow(int32_t* b) {  // 64 level-shifted samples, row-major
    for (int i = 0; i < 8; ++i) fdct8_pass(b + i * 8, 1, 0);
    for (int i = 0; i < 8; ++i) fdct8_pass(b + i, 8, 1);
}

#ifdef __AVX2__
// ---- AVX2 islow: one block per call, lanes = the 8 in-block positions.
// Same integer math as fdct8_pass, so bit-identical to every other tier.

static inline void avx_transpose8x8(__m256i v[8]) {
    __m256i t0 = _mm256_unpacklo_epi32(v[0], v[1]);
    __m256i t1 = _mm256_unpackhi_epi32(v[0], v[1]);
    __m256i t2 = _mm256_unpacklo_epi32(v[2], v[3]);
    __m256i t3 = _mm256_unpackhi_epi32(v[2], v[3]);
    __m256i t4 = _mm256_unpacklo_epi32(v[4], v[5]);
    __m256i t5 = _mm256_unpackhi_epi32(v[4], v[5]);
    __m256i t6 = _mm256_unpacklo_epi32(v[6], v[7]);
    __m256i t7 = _mm256_unpackhi_epi32(v[6], v[7]);
    __m256i u0 = _mm256_unpacklo_epi64(t0, t2);
    __m256i u1 = _mm256_unpackhi_epi64(t0, t2);
    __m256i u2 = _mm256_unpacklo_epi64(t1, t3);
    __m256i u3 = _mm256_unpackhi_epi64(t1, t3);
    __m256i u4 = _mm256_unpacklo_epi64(t4, t6);
    __m256i u5 = _mm256_unpackhi_epi64(t4, t6);
    __m256i u6 = _mm256_unpacklo_epi64(t5, t7);
    __m256i u7 = _mm256_unpackhi_epi64(t5, t7);
    v[0] = _mm256_permute2x128_si256(u0, u4, 0x20);
    v[1] = _mm256_permute2x128_si256(u1, u5, 0x20);
    v[2] = _mm256_permute2x128_si256(u2, u6, 0x20);
    v[3] = _mm256_permute2x128_si256(u3, u7, 0x20);
    v[4] = _mm256_permute2x128_si256(u0, u4, 0x31);
    v[5] = _mm256_permute2x128_si256(u1, u5, 0x31);
    v[6] = _mm256_permute2x128_si256(u2, u6, 0x31);
    v[7] = _mm256_permute2x128_si256(u3, u7, 0x31);
}

static inline __m256i avx_descale(__m256i x, int n) {
    return _mm256_srai_epi32(
        _mm256_add_epi32(x, _mm256_set1_epi32(1 << (n - 1))), n);
}

static inline __m256i avx_mulc(__m256i x, int c) {
    return _mm256_mullo_epi32(x, _mm256_set1_epi32(c));
}

// One butterfly pass over d[0..7] (each a ymm of 8 parallel instances).
static inline void avx_fdct_pass(__m256i d[8], int final_pass) {
    __m256i t0 = _mm256_add_epi32(d[0], d[7]), t7 = _mm256_sub_epi32(d[0], d[7]);
    __m256i t1 = _mm256_add_epi32(d[1], d[6]), t6 = _mm256_sub_epi32(d[1], d[6]);
    __m256i t2 = _mm256_add_epi32(d[2], d[5]), t5 = _mm256_sub_epi32(d[2], d[5]);
    __m256i t3 = _mm256_add_epi32(d[3], d[4]), t4 = _mm256_sub_epi32(d[3], d[4]);
    __m256i t10 = _mm256_add_epi32(t0, t3), t13 = _mm256_sub_epi32(t0, t3);
    __m256i t11 = _mm256_add_epi32(t1, t2), t12 = _mm256_sub_epi32(t1, t2);
    int shift;
    if (final_pass) {
        d[0] = avx_descale(_mm256_add_epi32(t10, t11), STITCH_PASS1_BITS);
        d[4] = avx_descale(_mm256_sub_epi32(t10, t11), STITCH_PASS1_BITS);
        shift = STITCH_CONST_BITS + STITCH_PASS1_BITS;
    } else {
        d[0] = _mm256_slli_epi32(_mm256_add_epi32(t10, t11), STITCH_PASS1_BITS);
        d[4] = _mm256_slli_epi32(_mm256_sub_epi32(t10, t11), STITCH_PASS1_BITS);
        shift = STITCH_CONST_BITS - STITCH_PASS1_BITS;
    }
    __m256i z1 = avx_mulc(_mm256_add_epi32(t12, t13), 4433);
    d[2] = avx_descale(_mm256_add_epi32(z1, avx_mulc(t13, 6270)), shift);
    d[6] = avx_descale(_mm256_sub_epi32(z1, avx_mulc(t12, 15137)), shift);
    z1 = _mm256_add_epi32(t4, t7);
    __m256i z2 = _mm256_add_epi32(t5, t6);
    __m256i z3 = _mm256_add_epi32(t4, t6);
    __m256i z4 = _mm256_add_epi32(t5, t7);
    __m256i z5 = avx_mulc(_mm256_add_epi32(z3, z4), 9633);
    t4 = avx_mulc(t4, 2446);
    t5 = avx_mulc(t5, 16819);
    t6 = avx_mulc(t6, 25172);
    t7 = avx_mulc(t7, 12299);
    z1 = avx_mulc(z1, -7373);
    z2 = avx_mulc(z2, -20995);
    z3 = _mm256_add_epi32(avx_mulc(z3, -16069), z5);
    z4 = _mm256_add_epi32(avx_mulc(z4, -3196), z5);
    d[7] = avx_descale(_mm256_add_epi32(_mm256_add_epi32(t4, z1), z3), shift);
    d[5] = avx_descale(_mm256_add_epi32(_mm256_add_epi32(t5, z2), z4), shift);
    d[3] = avx_descale(_mm256_add_epi32(_mm256_add_epi32(t6, z2), z3), shift);
    d[1] = avx_descale(_mm256_add_epi32(_mm256_add_epi32(t7, z1), z4), shift);
}

// Fused islow FDCT + exact quantize, one 8x8 block from an int16 plane
// (stride in elements). q4v/q8fv: per-row constants (see caller).
static void fdct8_quant_avx2(const int16_t* p, int64_t stride,
                             const __m256i* q4v, const __m256* q8fv,
                             const __m256i* q8iv, int16_t* out) {
    __m256i v[8];
    for (int y = 0; y < 8; ++y)
        v[y] = _mm256_cvtepi16_epi32(
            _mm_loadu_si128((const __m128i*)(p + y * stride)));
    // Row pass needs vectors indexed by x with lanes = y.
    avx_transpose8x8(v);
    avx_fdct_pass(v, 0);
    // Column pass needs vectors indexed by y with lanes = u.
    avx_transpose8x8(v);
    avx_fdct_pass(v, 1);
    // v[w] now holds coefficient row w (lanes = x-frequency).
    for (int w = 0; w < 8; ++w) {
        __m256i c = v[w];
        __m256i mag = _mm256_abs_epi32(c);
        __m256i num = _mm256_add_epi32(mag, q4v[w]);
        __m256 quotf = _mm256_floor_ps(
            _mm256_div_ps(_mm256_cvtepi32_ps(num), q8fv[w]));
        __m256i quot = _mm256_cvttps_epi32(quotf);
        // Exact integer floor-correction (TPU-parity semantics; a no-op
        // for IEEE division but keeps every tier's definition identical).
        __m256i rem = _mm256_sub_epi32(num, _mm256_mullo_epi32(quot, q8iv[w]));
        __m256i neg = _mm256_srai_epi32(rem, 31);  // rem < 0 -> all ones
        __m256i geq = _mm256_or_si256(
            _mm256_cmpgt_epi32(rem, q8iv[w]),
            _mm256_cmpeq_epi32(rem, q8iv[w]));
        quot = _mm256_add_epi32(quot, neg);                       // -1 where rem<0
        quot = _mm256_sub_epi32(quot, geq);                       // +1 where rem>=den
        __m256i sign = _mm256_srai_epi32(c, 31);
        quot = _mm256_sub_epi32(_mm256_xor_si256(quot, sign), sign);
        __m128i lo = _mm256_castsi256_si128(quot);
        __m128i hi = _mm256_extracti128_si256(quot, 1);
        _mm_storeu_si128((__m128i*)(out + w * 8), _mm_packs_epi32(lo, hi));
    }
}

// ---- 16-bit two-block islow FDCT (the hot path) ---------------------------
//
// Same T.81 A.3.3 flowgraph and descale sequence as fdct8_pass, carried in
// int16 lanes so one ymm holds a row of TWO horizontally adjacent blocks.
// Value-range proof (level-shifted samples in [-128, +128] — note +128:
// ycbcr_int rounds half up, so a saturated chroma sample maps to 256):
//   pass 1: |t0..t7| <= 256, |t10..t13| <= 512; outputs |DC| <= 4096
//     ((t10+t11) << 2) and |AC| <= descale(512 * 15136, 11) = 3784 — all
//     int16.  pass 2: inputs <= 4096 so |t0..t7| <= 8192 and |t10..t13|
//     <= 16384 — every paddw/psubw among THOSE is exact.  t10+t11 (the
//     sum of all eight inputs) can reach exactly +-32768 (flat saturated
//     chroma: 8 * 4096), one past int16 — so the final pass computes
//     d0/d4 through pmaddwd pairs in int32.  All dot products run through
//     pmaddwd into int32 (max |sum| <= 16384 * 15136 < 2^31).
// Each odd/even-AC output is computed as an expanded integer dot product
// of the butterfly terms — algebraically identical to the z1..z5 shared
// form (int32 addition is associative; every partial is in range), so the
// results are bit-identical to fdct8_pass on every input.
//   d2 =  4433*t12 + 10703*t13        d6 = -10704*t12 + 4433*t13
//   d1 =   2260*t4 +  6437*t5 +  9633*t6 + 11363*t7
//   d3 =  -6436*t4 - 11362*t5 -  2259*t6 +  9633*t7
//   d5 =   9633*t4 +  2261*t5 - 11362*t6 +  6437*t7
//   d7 = -11363*t4 +  9633*t5 -  6436*t6 +  2260*t7

static inline void avx2_transpose_2x8x8_epi16(__m256i v[8]) {
    __m256i t0 = _mm256_unpacklo_epi16(v[0], v[1]);
    __m256i t1 = _mm256_unpackhi_epi16(v[0], v[1]);
    __m256i t2 = _mm256_unpacklo_epi16(v[2], v[3]);
    __m256i t3 = _mm256_unpackhi_epi16(v[2], v[3]);
    __m256i t4 = _mm256_unpacklo_epi16(v[4], v[5]);
    __m256i t5 = _mm256_unpackhi_epi16(v[4], v[5]);
    __m256i t6 = _mm256_unpacklo_epi16(v[6], v[7]);
    __m256i t7 = _mm256_unpackhi_epi16(v[6], v[7]);
    __m256i u0 = _mm256_unpacklo_epi32(t0, t2);
    __m256i u1 = _mm256_unpackhi_epi32(t0, t2);
    __m256i u2 = _mm256_unpacklo_epi32(t1, t3);
    __m256i u3 = _mm256_unpackhi_epi32(t1, t3);
    __m256i u4 = _mm256_unpacklo_epi32(t4, t6);
    __m256i u5 = _mm256_unpackhi_epi32(t4, t6);
    __m256i u6 = _mm256_unpacklo_epi32(t5, t7);
    __m256i u7 = _mm256_unpackhi_epi32(t5, t7);
    v[0] = _mm256_unpacklo_epi64(u0, u4);
    v[1] = _mm256_unpackhi_epi64(u0, u4);
    v[2] = _mm256_unpacklo_epi64(u1, u5);
    v[3] = _mm256_unpackhi_epi64(u1, u5);
    v[4] = _mm256_unpacklo_epi64(u2, u6);
    v[5] = _mm256_unpackhi_epi64(u2, u6);
    v[6] = _mm256_unpacklo_epi64(u3, u7);
    v[7] = _mm256_unpackhi_epi64(u3, u7);
}

#define STITCH_PAIR16(a, b) \
    _mm256_set1_epi32(((int32_t)(uint16_t)(b) << 16) | (uint16_t)(a))

// One butterfly pass over 16 independent instances (two blocks).
static inline void avx2_fdct16_pass(__m256i v[8], int final_pass) {
    __m256i t0 = _mm256_add_epi16(v[0], v[7]), t7 = _mm256_sub_epi16(v[0], v[7]);
    __m256i t1 = _mm256_add_epi16(v[1], v[6]), t6 = _mm256_sub_epi16(v[1], v[6]);
    __m256i t2 = _mm256_add_epi16(v[2], v[5]), t5 = _mm256_sub_epi16(v[2], v[5]);
    __m256i t3 = _mm256_add_epi16(v[3], v[4]), t4 = _mm256_sub_epi16(v[3], v[4]);
    __m256i t10 = _mm256_add_epi16(t0, t3), t13 = _mm256_sub_epi16(t0, t3);
    __m256i t11 = _mm256_add_epi16(t1, t2), t12 = _mm256_sub_epi16(t1, t2);
    int shift;
    if (final_pass) {
        // t10 + t11 can be exactly +-2^15 (see range proof) — widen via
        // pmaddwd pairs so the DC/d4 sums happen in int32.
        __m256i p_lo = _mm256_unpacklo_epi16(t10, t11);
        __m256i p_hi = _mm256_unpackhi_epi16(t10, t11);
        __m256i cpp = STITCH_PAIR16(1, 1);
        __m256i cpm = STITCH_PAIR16(1, -1);
        __m256i r2 = _mm256_set1_epi32(2);
        v[0] = _mm256_packs_epi32(
            _mm256_srai_epi32(_mm256_add_epi32(
                _mm256_madd_epi16(p_lo, cpp), r2), STITCH_PASS1_BITS),
            _mm256_srai_epi32(_mm256_add_epi32(
                _mm256_madd_epi16(p_hi, cpp), r2), STITCH_PASS1_BITS));
        v[4] = _mm256_packs_epi32(
            _mm256_srai_epi32(_mm256_add_epi32(
                _mm256_madd_epi16(p_lo, cpm), r2), STITCH_PASS1_BITS),
            _mm256_srai_epi32(_mm256_add_epi32(
                _mm256_madd_epi16(p_hi, cpm), r2), STITCH_PASS1_BITS));
        shift = STITCH_CONST_BITS + STITCH_PASS1_BITS;
    } else {
        v[0] = _mm256_slli_epi16(_mm256_add_epi16(t10, t11), STITCH_PASS1_BITS);
        v[4] = _mm256_slli_epi16(_mm256_sub_epi16(t10, t11), STITCH_PASS1_BITS);
        shift = STITCH_CONST_BITS - STITCH_PASS1_BITS;
    }
    __m256i rnd = _mm256_set1_epi32(1 << (shift - 1));
#define STITCH_DOT2(lo_or_hi, ca, cb) \
    _mm256_srai_epi32(_mm256_add_epi32(_mm256_add_epi32( \
        _mm256_madd_epi16(o1_##lo_or_hi, ca), \
        _mm256_madd_epi16(o2_##lo_or_hi, cb)), rnd), shift)
    __m256i e_lo = _mm256_unpacklo_epi16(t12, t13);
    __m256i e_hi = _mm256_unpackhi_epi16(t12, t13);
    __m256i c26a = STITCH_PAIR16(4433, 10703);
    __m256i c26b = STITCH_PAIR16(-10704, 4433);
    v[2] = _mm256_packs_epi32(
        _mm256_srai_epi32(_mm256_add_epi32(_mm256_madd_epi16(e_lo, c26a), rnd), shift),
        _mm256_srai_epi32(_mm256_add_epi32(_mm256_madd_epi16(e_hi, c26a), rnd), shift));
    v[6] = _mm256_packs_epi32(
        _mm256_srai_epi32(_mm256_add_epi32(_mm256_madd_epi16(e_lo, c26b), rnd), shift),
        _mm256_srai_epi32(_mm256_add_epi32(_mm256_madd_epi16(e_hi, c26b), rnd), shift));
    __m256i o1_lo = _mm256_unpacklo_epi16(t4, t5);
    __m256i o1_hi = _mm256_unpackhi_epi16(t4, t5);
    __m256i o2_lo = _mm256_unpacklo_epi16(t6, t7);
    __m256i o2_hi = _mm256_unpackhi_epi16(t6, t7);
    __m256i c1a = STITCH_PAIR16(2260, 6437);
    __m256i c1b = STITCH_PAIR16(9633, 11363);
    __m256i c3a = STITCH_PAIR16(-6436, -11362);
    __m256i c3b = STITCH_PAIR16(-2259, 9633);
    __m256i c5a = STITCH_PAIR16(9633, 2261);
    __m256i c5b = STITCH_PAIR16(-11362, 6437);
    __m256i c7a = STITCH_PAIR16(-11363, 9633);
    __m256i c7b = STITCH_PAIR16(-6436, 2260);
    v[1] = _mm256_packs_epi32(STITCH_DOT2(lo, c1a, c1b), STITCH_DOT2(hi, c1a, c1b));
    v[3] = _mm256_packs_epi32(STITCH_DOT2(lo, c3a, c3b), STITCH_DOT2(hi, c3a, c3b));
    v[5] = _mm256_packs_epi32(STITCH_DOT2(lo, c5a, c5b), STITCH_DOT2(hi, c5a, c5b));
    v[7] = _mm256_packs_epi32(STITCH_DOT2(lo, c7a, c7b), STITCH_DOT2(hi, c7a, c7b));
#undef STITCH_DOT2
}

// Quantize one coefficient row (8 int32 lanes).  No floor-correction here:
// with num = |c| + 4q <= 15843 and den = 8q <= 2040 both exactly
// representable in f32 and the division correctly rounded (IEEE x86), a
// non-integer true quotient sits >= 1/den from any integer while the
// rounding error is < (num/den) * 2^-24 — the floor can only cross if
// 2^24 <= num, which never holds; an integer quotient is returned exactly.
// So floor(fl(num/den)) == floor(num/den) unconditionally on this tier.
// (The scalar/numpy/XLA tiers keep the explicit integer correction, which
// is the shared cross-tier definition; TPU needs it — its f32 divide is a
// reciprocal approximation.)
static inline void avx2_quant_row(__m256i c, __m256i q4, __m256 q8f,
                                  int16_t* out) {
    __m256i mag = _mm256_abs_epi32(c);
    __m256i num = _mm256_add_epi32(mag, q4);
    __m256 quotf = _mm256_floor_ps(
        _mm256_div_ps(_mm256_cvtepi32_ps(num), q8f));
    __m256i quot = _mm256_cvttps_epi32(quotf);
    __m256i sign = _mm256_srai_epi32(c, 31);
    quot = _mm256_sub_epi32(_mm256_xor_si256(quot, sign), sign);
    __m128i lo = _mm256_castsi256_si128(quot);
    __m128i hi = _mm256_extracti128_si256(quot, 1);
    _mm_storeu_si128((__m128i*)out, _mm_packs_epi32(lo, hi));
}

// Two horizontally adjacent blocks from an int16 plane in one sweep:
// bit-identical to fdct8_quant_avx2 per block at ~1.4x the throughput
// (validated against the scalar flowgraph over adversarial full-range
// blocks; see tests/unit/test_jpeg_dct.py cross-tier suites).
static void fdct8x2_quant_avx2(const int16_t* p, int64_t stride,
                               const __m256i* q4v, const __m256* q8fv,
                               int16_t* outA, int16_t* outB) {
    __m256i v[8];
    for (int y = 0; y < 8; ++y)
        v[y] = _mm256_loadu_si256((const __m256i*)(p + y * stride));
    avx2_transpose_2x8x8_epi16(v);  // lanes = y, regs = x
    avx2_fdct16_pass(v, 0);          // row pass (transform along x)
    avx2_transpose_2x8x8_epi16(v);  // lanes = x-frequency, regs = y
    avx2_fdct16_pass(v, 1);          // column pass
    for (int u = 0; u < 8; ++u) {
        __m256i cA = _mm256_cvtepi16_epi32(_mm256_castsi256_si128(v[u]));
        __m256i cB = _mm256_cvtepi16_epi32(_mm256_extracti128_si256(v[u], 1));
        avx2_quant_row(cA, q4v[u], q8fv[u], outA + u * 8);
        avx2_quant_row(cB, q4v[u], q8fv[u], outB + u * 8);
    }
}

#if defined(__AVX512BW__) && defined(__AVX512DQ__)
// ---- 16-bit FOUR-block islow FDCT (AVX-512) -------------------------------
//
// One zmm row spans four horizontally adjacent blocks (32 int16 lanes).
// Every operation below (unpack, madd, packs, add/sub/slli) is local to a
// 128-bit lane, so this is the exact per-lane op sequence of
// avx2_fdct16_pass / avx2_transpose_2x8x8_epi16 run over four blocks at
// once — bit-identical per block by construction (same value-range proof).

static inline void avx512_transpose_4x8x8_epi16(__m512i v[8]) {
    __m512i t0 = _mm512_unpacklo_epi16(v[0], v[1]);
    __m512i t1 = _mm512_unpackhi_epi16(v[0], v[1]);
    __m512i t2 = _mm512_unpacklo_epi16(v[2], v[3]);
    __m512i t3 = _mm512_unpackhi_epi16(v[2], v[3]);
    __m512i t4 = _mm512_unpacklo_epi16(v[4], v[5]);
    __m512i t5 = _mm512_unpackhi_epi16(v[4], v[5]);
    __m512i t6 = _mm512_unpacklo_epi16(v[6], v[7]);
    __m512i t7 = _mm512_unpackhi_epi16(v[6], v[7]);
    __m512i u0 = _mm512_unpacklo_epi32(t0, t2);
    __m512i u1 = _mm512_unpackhi_epi32(t0, t2);
    __m512i u2 = _mm512_unpacklo_epi32(t1, t3);
    __m512i u3 = _mm512_unpackhi_epi32(t1, t3);
    __m512i u4 = _mm512_unpacklo_epi32(t4, t6);
    __m512i u5 = _mm512_unpackhi_epi32(t4, t6);
    __m512i u6 = _mm512_unpacklo_epi32(t5, t7);
    __m512i u7 = _mm512_unpackhi_epi32(t5, t7);
    v[0] = _mm512_unpacklo_epi64(u0, u4);
    v[1] = _mm512_unpackhi_epi64(u0, u4);
    v[2] = _mm512_unpacklo_epi64(u1, u5);
    v[3] = _mm512_unpackhi_epi64(u1, u5);
    v[4] = _mm512_unpacklo_epi64(u2, u6);
    v[5] = _mm512_unpackhi_epi64(u2, u6);
    v[6] = _mm512_unpacklo_epi64(u3, u7);
    v[7] = _mm512_unpackhi_epi64(u3, u7);
}

#define STITCH_PAIR16_Z(a, b) \
    _mm512_set1_epi32(((int32_t)(uint16_t)(b) << 16) | (uint16_t)(a))

// One butterfly pass over 32 independent instances (four blocks).
static inline void avx512_fdct32_pass(__m512i v[8], int final_pass) {
    __m512i t0 = _mm512_add_epi16(v[0], v[7]), t7 = _mm512_sub_epi16(v[0], v[7]);
    __m512i t1 = _mm512_add_epi16(v[1], v[6]), t6 = _mm512_sub_epi16(v[1], v[6]);
    __m512i t2 = _mm512_add_epi16(v[2], v[5]), t5 = _mm512_sub_epi16(v[2], v[5]);
    __m512i t3 = _mm512_add_epi16(v[3], v[4]), t4 = _mm512_sub_epi16(v[3], v[4]);
    __m512i t10 = _mm512_add_epi16(t0, t3), t13 = _mm512_sub_epi16(t0, t3);
    __m512i t11 = _mm512_add_epi16(t1, t2), t12 = _mm512_sub_epi16(t1, t2);
    int shift;
    if (final_pass) {
        __m512i p_lo = _mm512_unpacklo_epi16(t10, t11);
        __m512i p_hi = _mm512_unpackhi_epi16(t10, t11);
        __m512i cpp = STITCH_PAIR16_Z(1, 1);
        __m512i cpm = STITCH_PAIR16_Z(1, -1);
        __m512i r2 = _mm512_set1_epi32(2);
        v[0] = _mm512_packs_epi32(
            _mm512_srai_epi32(_mm512_add_epi32(
                _mm512_madd_epi16(p_lo, cpp), r2), STITCH_PASS1_BITS),
            _mm512_srai_epi32(_mm512_add_epi32(
                _mm512_madd_epi16(p_hi, cpp), r2), STITCH_PASS1_BITS));
        v[4] = _mm512_packs_epi32(
            _mm512_srai_epi32(_mm512_add_epi32(
                _mm512_madd_epi16(p_lo, cpm), r2), STITCH_PASS1_BITS),
            _mm512_srai_epi32(_mm512_add_epi32(
                _mm512_madd_epi16(p_hi, cpm), r2), STITCH_PASS1_BITS));
        shift = STITCH_CONST_BITS + STITCH_PASS1_BITS;
    } else {
        v[0] = _mm512_slli_epi16(_mm512_add_epi16(t10, t11), STITCH_PASS1_BITS);
        v[4] = _mm512_slli_epi16(_mm512_sub_epi16(t10, t11), STITCH_PASS1_BITS);
        shift = STITCH_CONST_BITS - STITCH_PASS1_BITS;
    }
    __m512i rnd = _mm512_set1_epi32(1 << (shift - 1));
#define STITCH_DOT2_Z(lo_or_hi, ca, cb) \
    _mm512_srai_epi32(_mm512_add_epi32(_mm512_add_epi32( \
        _mm512_madd_epi16(o1_##lo_or_hi, ca), \
        _mm512_madd_epi16(o2_##lo_or_hi, cb)), rnd), shift)
    __m512i e_lo = _mm512_unpacklo_epi16(t12, t13);
    __m512i e_hi = _mm512_unpackhi_epi16(t12, t13);
    __m512i c26a = STITCH_PAIR16_Z(4433, 10703);
    __m512i c26b = STITCH_PAIR16_Z(-10704, 4433);
    v[2] = _mm512_packs_epi32(
        _mm512_srai_epi32(_mm512_add_epi32(_mm512_madd_epi16(e_lo, c26a), rnd), shift),
        _mm512_srai_epi32(_mm512_add_epi32(_mm512_madd_epi16(e_hi, c26a), rnd), shift));
    v[6] = _mm512_packs_epi32(
        _mm512_srai_epi32(_mm512_add_epi32(_mm512_madd_epi16(e_lo, c26b), rnd), shift),
        _mm512_srai_epi32(_mm512_add_epi32(_mm512_madd_epi16(e_hi, c26b), rnd), shift));
    __m512i o1_lo = _mm512_unpacklo_epi16(t4, t5);
    __m512i o1_hi = _mm512_unpackhi_epi16(t4, t5);
    __m512i o2_lo = _mm512_unpacklo_epi16(t6, t7);
    __m512i o2_hi = _mm512_unpackhi_epi16(t6, t7);
    __m512i c1a = STITCH_PAIR16_Z(2260, 6437);
    __m512i c1b = STITCH_PAIR16_Z(9633, 11363);
    __m512i c3a = STITCH_PAIR16_Z(-6436, -11362);
    __m512i c3b = STITCH_PAIR16_Z(-2259, 9633);
    __m512i c5a = STITCH_PAIR16_Z(9633, 2261);
    __m512i c5b = STITCH_PAIR16_Z(-11362, 6437);
    __m512i c7a = STITCH_PAIR16_Z(-11363, 9633);
    __m512i c7b = STITCH_PAIR16_Z(-6436, 2260);
    v[1] = _mm512_packs_epi32(STITCH_DOT2_Z(lo, c1a, c1b), STITCH_DOT2_Z(hi, c1a, c1b));
    v[3] = _mm512_packs_epi32(STITCH_DOT2_Z(lo, c3a, c3b), STITCH_DOT2_Z(hi, c3a, c3b));
    v[5] = _mm512_packs_epi32(STITCH_DOT2_Z(lo, c5a, c5b), STITCH_DOT2_Z(hi, c5a, c5b));
    v[7] = _mm512_packs_epi32(STITCH_DOT2_Z(lo, c7a, c7b), STITCH_DOT2_Z(hi, c7a, c7b));
#undef STITCH_DOT2_Z
}

// Quantize coefficient row u of two blocks (16 int32 lanes: 8 coeffs of
// block A then 8 of B; q4/q8f carry the 8 per-row constants duplicated).
// Same no-correction IEEE-division argument as avx2_quant_row. (A
// reciprocal-multiply + integer-fixup variant measured 0.91x of this on
// Sapphire Rapids — the 512-bit divider is fast and vpmulld's 2 uops plus
// the fixup dependency chain cost more than the divide; don't retry.)
static inline void avx512_quant_row16(__m512i c, __m512i q4, __m512 q8f,
                                      int16_t* outA, int16_t* outB, int u) {
    __m512i mag = _mm512_abs_epi32(c);
    __m512i num = _mm512_add_epi32(mag, q4);
    __m512 quotf = _mm512_roundscale_ps(
        _mm512_div_ps(_mm512_cvtepi32_ps(num), q8f),
        _MM_FROUND_TO_NEG_INF | _MM_FROUND_NO_EXC);
    __m512i quot = _mm512_cvttps_epi32(quotf);
    __m512i sign = _mm512_srai_epi32(c, 31);
    quot = _mm512_sub_epi32(_mm512_xor_si512(quot, sign), sign);
    __m256i r = _mm512_cvtsepi32_epi16(quot);  // in-order signed saturate
    _mm_storeu_si128((__m128i*)(outA + u * 8), _mm256_castsi256_si128(r));
    _mm_storeu_si128((__m128i*)(outB + u * 8), _mm256_extracti128_si256(r, 1));
}

// Four horizontally adjacent blocks in one sweep; bit-identical to
// fdct8x2_quant_avx2 per block (same lane-local op sequence).
static void fdct8x4_quant_avx512(const int16_t* p, int64_t stride,
                                 const __m512i* q4z, const __m512* q8fz,
                                 int16_t* outA, int16_t* outB,
                                 int16_t* outC, int16_t* outD) {
    __m512i v[8];
    for (int y = 0; y < 8; ++y)
        v[y] = _mm512_loadu_si512((const void*)(p + y * stride));
    avx512_transpose_4x8x8_epi16(v);  // lanes = y, regs = x
    avx512_fdct32_pass(v, 0);          // row pass
    avx512_transpose_4x8x8_epi16(v);  // lanes = x-frequency, regs = y
    avx512_fdct32_pass(v, 1);          // column pass
    for (int u = 0; u < 8; ++u) {
        __m512i cAB = _mm512_cvtepi16_epi32(_mm512_castsi512_si256(v[u]));
        __m512i cCD = _mm512_cvtepi16_epi32(_mm512_extracti64x4_epi64(v[u], 1));
        avx512_quant_row16(cAB, q4z[u], q8fz[u], outA, outB, u);
        avx512_quant_row16(cCD, q4z[u], q8fz[u], outC, outD, u);
    }
}
#endif  // __AVX512BW__ && __AVX512DQ__
#endif

// Core convert+FDCT+quantize sweep. Two modes:
//  - split (out == NULL): write all blocks to yout/cbout/crout (band-major),
//    the historical jpeg_quant_band_444 contract.
//  - fused (out != NULL): blocks land in a strip-local scratch that stays
//    L2-resident and are entropy-coded immediately (luma/chroma/st), so the
//    ~6 MB of block arrays per strip-band never round-trip DRAM between the
//    quant and entropy stages. Returns bytes written, or -1 if capacity
//    would be exceeded. Byte stream identical to quant-then-encode.
static int64_t quant_entropy_core_444(
    const uint8_t* rgba, int64_t h, int64_t w,
    const int32_t* lq, const int32_t* cq,
    int16_t* yout, int16_t* cbout, int16_t* crout,
    const HuffTable* luma, const HuffTable* chroma,
    EntropyState* st, uint8_t* out, int64_t capacity) {
    // Per-coefficient quantizer constants: floor((|c| + 4q) / (8q)) via
    // an f32 divide + exact integer floor-correction (mirrors
    // ops/jpeg_dct.quantize_islow: TPU divides via reciprocal
    // approximation, so every tier corrects the floor in integers and
    // all agree bit for bit; on x86 the correction is a no-op).
    int32_t l4[64], c4[64];
    float l8f[64], c8f[64];
    for (int i = 0; i < 64; ++i) {
        l4[i] = 4 * lq[i];
        c4[i] = 4 * cq[i];
        l8f[i] = (float)(8 * lq[i]);
        c8f[i] = (float)(8 * cq[i]);
    }
#ifdef __AVX2__
    __m256i l4v[8], c4v[8], l8iv[8], c8iv[8];
    __m256 l8fv[8], c8fv[8];
    for (int r = 0; r < 8; ++r) {
        l4v[r] = _mm256_loadu_si256((const __m256i*)(l4 + r * 8));
        c4v[r] = _mm256_loadu_si256((const __m256i*)(c4 + r * 8));
        l8fv[r] = _mm256_loadu_ps(l8f + r * 8);
        c8fv[r] = _mm256_loadu_ps(c8f + r * 8);
        int32_t li[8], ci[8];
        for (int k = 0; k < 8; ++k) { li[k] = 8 * lq[r * 8 + k]; ci[k] = 8 * cq[r * 8 + k]; }
        l8iv[r] = _mm256_loadu_si256((const __m256i*)li);
        c8iv[r] = _mm256_loadu_si256((const __m256i*)ci);
    }
#if defined(__AVX512BW__) && defined(__AVX512DQ__)
    __m512i l4z[8], c4z[8];
    __m512 l8fz[8], c8fz[8];
    for (int r = 0; r < 8; ++r) {
        l4z[r] = _mm512_broadcast_i32x8(l4v[r]);
        c4z[r] = _mm512_broadcast_i32x8(c4v[r]);
        l8fz[r] = _mm512_broadcast_f32x8(l8fv[r]);
        c8fz[r] = _mm512_broadcast_f32x8(c8fv[r]);
    }
#endif
#endif
    int64_t bx = w / 8;
    // Strip-at-a-time: convert 8 interleaved RGBA rows into three planar
    // (8, w) int16 buffers (level-shifted) with one contiguous sweep
    // (auto-vectorizes), then FDCT+quantize each 8x8 block. Fused mode adds
    // a strip-local block scratch (3 * bx * 64 int16).
    size_t plane_elems = (size_t)(3 * 8 * w);
    size_t scratch_elems = out ? (size_t)(3 * bx * 64) : 0;
    int16_t* planes = (int16_t*)malloc(
        (plane_elems + scratch_elems) * sizeof(int16_t));
    int16_t* yp = planes;
    int16_t* cbp = planes + 8 * w;
    int16_t* crp = planes + 16 * w;
    int16_t* ystrip = planes + plane_elems;
    int16_t* cbstrip = ystrip + bx * 64;
    int16_t* crstrip = cbstrip + bx * 64;
    uint8_t* p = out;
    const uint8_t* pend = out ? out + capacity : NULL;
    int32_t blk[64];
    for (int64_t sy = 0; sy < h / 8; ++sy) {
        int16_t* ybase = out ? ystrip : yout + sy * bx * 64;
        int16_t* cbbase = out ? cbstrip : cbout + sy * bx * 64;
        int16_t* crbase = out ? crstrip : crout + sy * bx * 64;
        const uint8_t* src = rgba + sy * 8 * w * 4;
        int64_t n = 8 * w;
        int64_t i = 0;
#if defined(__AVX512BW__) && defined(__AVX512DQ__)
        {
            // vpshufb + vpmaddwd formulation of the same integer formulas:
            // the oversized Y green coefficient splits exactly
            // (38470 = 19235 + 19235 across the [R,G] and [G,B] pairs) and
            // the +-32768 coefficients become shifts, so every sum is the
            // identical int32 the scalar code computes. The -128 level
            // shift folds into the bias (-128*2^16 is shift-exact).
            const __m512i shuf_rg = _mm512_broadcast_i32x4(_mm_setr_epi8(
                0, -1, 1, -1, 4, -1, 5, -1, 8, -1, 9, -1, 12, -1, 13, -1));
            const __m512i shuf_gb = _mm512_broadcast_i32x4(_mm_setr_epi8(
                1, -1, 2, -1, 5, -1, 6, -1, 9, -1, 10, -1, 13, -1, 14, -1));
            const __m512i shuf_r = _mm512_broadcast_i32x4(_mm_setr_epi8(
                0, -1, -1, -1, 4, -1, -1, -1, 8, -1, -1, -1, 12, -1, -1, -1));
            const __m512i shuf_b = _mm512_broadcast_i32x4(_mm_setr_epi8(
                2, -1, -1, -1, 6, -1, -1, -1, 10, -1, -1, -1, 14, -1, -1, -1));
            const __m512i cy_rg = STITCH_PAIR16_Z(19595, 19235);
            const __m512i cy_gb = STITCH_PAIR16_Z(19235, 7471);
            const __m512i ccb_rg = STITCH_PAIR16_Z(-11059, -21709);
            const __m512i ccr_gb = STITCH_PAIR16_Z(-27439, -5329);
            const __m512i bias_y = _mm512_set1_epi32(32768 - (128 << 16));
            const __m512i bias_c = _mm512_set1_epi32(32768);
            for (; i + 16 <= n; i += 16) {
                __m512i v = _mm512_loadu_si512((const void*)(src + i * 4));
                __m512i rg = _mm512_shuffle_epi8(v, shuf_rg);
                __m512i gb = _mm512_shuffle_epi8(v, shuf_gb);
                __m512i r32 = _mm512_shuffle_epi8(v, shuf_r);
                __m512i b32 = _mm512_shuffle_epi8(v, shuf_b);
                __m512i ys = _mm512_add_epi32(
                    _mm512_add_epi32(_mm512_madd_epi16(rg, cy_rg),
                                     _mm512_madd_epi16(gb, cy_gb)),
                    bias_y);
                __m512i cbs = _mm512_add_epi32(
                    _mm512_add_epi32(_mm512_madd_epi16(rg, ccb_rg),
                                     _mm512_slli_epi32(b32, 15)),
                    bias_c);
                __m512i crs = _mm512_add_epi32(
                    _mm512_add_epi32(_mm512_madd_epi16(gb, ccr_gb),
                                     _mm512_slli_epi32(r32, 15)),
                    bias_c);
                _mm256_storeu_si256((__m256i*)(yp + i),
                    _mm512_cvtepi32_epi16(_mm512_srai_epi32(ys, 16)));
                _mm256_storeu_si256((__m256i*)(cbp + i),
                    _mm512_cvtepi32_epi16(_mm512_srai_epi32(cbs, 16)));
                _mm256_storeu_si256((__m256i*)(crp + i),
                    _mm512_cvtepi32_epi16(_mm512_srai_epi32(crs, 16)));
            }
        }
#endif
        for (; i < n; ++i) {
            int32_t r = src[i * 4 + 0];
            int32_t g = src[i * 4 + 1];
            int32_t b = src[i * 4 + 2];
            yp[i] = (int16_t)(((19595 * r + 38470 * g + 7471 * b + 32768) >> 16) - 128);
            cbp[i] = (int16_t)(((-11059 * r - 21709 * g + 32768 * b + 32768 + (128 << 16)) >> 16) - 128);
            crp[i] = (int16_t)(((32768 * r - 27439 * g - 5329 * b + 32768 + (128 << 16)) >> 16) - 128);
        }
#ifdef __AVX2__
        // Quads of horizontally adjacent blocks through the AVX-512 path
        // when available, pairs through the 16-bit AVX2 path, and a
        // trailing odd block through the one-block int32 path — all three
        // bit-identical per block.
        int64_t sx0 = 0;
#if defined(__AVX512BW__) && defined(__AVX512DQ__)
        for (; sx0 + 3 < bx; sx0 += 4) {
            fdct8x4_quant_avx512(yp + sx0 * 8, w, l4z, l8fz,
                                 ybase + sx0 * 64, ybase + (sx0 + 1) * 64,
                                 ybase + (sx0 + 2) * 64, ybase + (sx0 + 3) * 64);
            fdct8x4_quant_avx512(cbp + sx0 * 8, w, c4z, c8fz,
                                 cbbase + sx0 * 64, cbbase + (sx0 + 1) * 64,
                                 cbbase + (sx0 + 2) * 64, cbbase + (sx0 + 3) * 64);
            fdct8x4_quant_avx512(crp + sx0 * 8, w, c4z, c8fz,
                                 crbase + sx0 * 64, crbase + (sx0 + 1) * 64,
                                 crbase + (sx0 + 2) * 64, crbase + (sx0 + 3) * 64);
        }
#endif
        for (int64_t sx = sx0; sx + 1 < bx; sx += 2) {
            fdct8x2_quant_avx2(yp + sx * 8, w, l4v, l8fv,
                               ybase + sx * 64, ybase + (sx + 1) * 64);
            fdct8x2_quant_avx2(cbp + sx * 8, w, c4v, c8fv,
                               cbbase + sx * 64, cbbase + (sx + 1) * 64);
            fdct8x2_quant_avx2(crp + sx * 8, w, c4v, c8fv,
                               crbase + sx * 64, crbase + (sx + 1) * 64);
        }
        for (int64_t sx = sx0 + ((bx - sx0) & ~(int64_t)1); sx < bx; ++sx) {
            const struct { const int16_t* plane; const __m256i* q4v;
                           const __m256* q8fv; const __m256i* q8iv;
                           int16_t* out; } jobs[3] = {
                {yp, l4v, l8fv, l8iv, ybase + sx * 64},
                {cbp, c4v, c8fv, c8iv, cbbase + sx * 64},
                {crp, c4v, c8fv, c8iv, crbase + sx * 64}};
            for (int j = 0; j < 3; ++j)
                fdct8_quant_avx2(jobs[j].plane + sx * 8, w, jobs[j].q4v,
                                 jobs[j].q8fv, jobs[j].q8iv, jobs[j].out);
        }
#else
        for (int64_t sx = 0; sx < bx; ++sx) {
            const struct { const int16_t* plane; const int32_t* q4;
                           const float* q8f; int16_t* out; } jobs[3] = {
                {yp, l4, l8f, ybase + sx * 64},
                {cbp, c4, c8f, cbbase + sx * 64},
                {crp, c4, c8f, crbase + sx * 64}};
            for (int j = 0; j < 3; ++j) {
                const int16_t* p = jobs[j].plane + sx * 8;
                for (int yy = 0; yy < 8; ++yy)
                    for (int xx = 0; xx < 8; ++xx)
                        blk[yy * 8 + xx] = p[yy * w + xx];
                fdct8_islow(blk);
                int16_t* o = jobs[j].out;
                const int32_t* q4 = jobs[j].q4;
                const float* q8f = jobs[j].q8f;
                for (int i = 0; i < 64; ++i) {
                    int32_t c = blk[i];
                    int32_t mag = c < 0 ? -c : c;
                    int32_t num = mag + q4[i];
                    int32_t den = (int32_t)q8f[i];
                    int32_t quot = (int32_t)__builtin_floorf((float)num / q8f[i]);
                    int32_t rem = num - quot * den;
                    if (rem < 0) quot -= 1;
                    else if (rem >= den) quot += 1;
                    o[i] = (int16_t)(c < 0 ? -quot : quot);
                }
            }
        }
#endif
        if (out) {
            // Entropy-code this strip's MCUs while the blocks are L2-hot.
            for (int64_t sx = 0; sx < bx; ++sx) {
                if (pend - p < 3 * kMaxBlockBytes) { free(planes); return -1; }
                encode_block(st, &p, ybase + sx * 64, luma, 0);
                encode_block(st, &p, cbbase + sx * 64, chroma, 1);
                encode_block(st, &p, crbase + sx * 64, chroma, 2);
            }
        }
    }
    free(planes);
    return out ? (int64_t)(p - out) : 0;
}

void jpeg_quant_band_444(const uint8_t* rgba, int64_t h, int64_t w,
                         const int32_t* lq, const int32_t* cq,
                         int16_t* yout, int16_t* cbout, int16_t* crout) {
    quant_entropy_core_444(rgba, h, w, lq, cq, yout, cbout, crout,
                           NULL, NULL, NULL, NULL, 0);
}

// Fused convert+FDCT+quantize+entropy over a whole 4:4:4 band: one DRAM
// pass over the RGBA input, blocks stay strip-local. Byte stream identical
// to jpeg_quant_band_444 -> jpeg_entropy_encode_444. Returns bytes written
// or -1 when `capacity` would be exceeded (caller falls back to the split
// path). Replaces the reference's per-strip WASM encode_strip
// (jpeg-encoder.ts:162) at band granularity.
int64_t jpeg_quant_entropy_band_444(
    const uint8_t* rgba, int64_t h, int64_t w,
    const int32_t* lq, const int32_t* cq,
    const HuffTable* luma, const HuffTable* chroma,
    EntropyState* state, uint8_t* out, int64_t capacity) {
    return quant_entropy_core_444(rgba, h, w, lq, cq, NULL, NULL, NULL,
                                  luma, chroma, state, out, capacity);
}

// --- 4:2:0 ---------------------------------------------------------------
//
// Native mirror of ops/jpeg_dct.band_to_blocks_islow_420: full-res Y (MCU
// block order TL,TR,BL,BR), chroma 2x2 box-averaged with (sum+2)>>2.
// Averaging LEVEL-SHIFTED samples is exact: subtracting 4*128 = 512 (a
// multiple of 4) commutes with the floored divide-by-4, so
// (sum_shifted+2)>>2 == ((sum_unshifted+2)>>2) - 128 — the same integers
// the numpy tier computes, hence bit-identical quantized blocks.

// FDCT+quantize one plane row of blocks into per-block out pointers.
static inline void quant_plane_row(
    const int16_t* plane, int64_t stride, int64_t bx,
    int16_t* base, int64_t idx0, int64_t idx_step_pattern,
#ifdef __AVX2__
    const __m256i* q4v, const __m256* q8fv, const __m256i* q8iv,
#if defined(__AVX512BW__) && defined(__AVX512DQ__)
    const __m512i* q4z, const __m512* q8fz,
#endif
#endif
    const int32_t* q4, const float* q8f,
    int16_t* (*slot)(int16_t* base, int64_t sx, void* ctx), void* ctx) {
    (void)idx0; (void)idx_step_pattern;
    int64_t sx = 0;
#ifdef __AVX2__
#if defined(__AVX512BW__) && defined(__AVX512DQ__)
    for (; sx + 3 < bx; sx += 4)
        fdct8x4_quant_avx512(plane + sx * 8, stride, q4z, q8fz,
                             slot(base, sx, ctx), slot(base, sx + 1, ctx),
                             slot(base, sx + 2, ctx), slot(base, sx + 3, ctx));
#endif
    for (; sx + 1 < bx; sx += 2)
        fdct8x2_quant_avx2(plane + sx * 8, stride, q4v, q8fv,
                           slot(base, sx, ctx), slot(base, sx + 1, ctx));
    for (; sx < bx; ++sx)
        fdct8_quant_avx2(plane + sx * 8, stride, q4v, q8fv, q8iv,
                         slot(base, sx, ctx));
    (void)q4; (void)q8f;
#else
    int32_t blk[64];
    for (; sx < bx; ++sx) {
        const int16_t* p = plane + sx * 8;
        for (int yy = 0; yy < 8; ++yy)
            for (int xx = 0; xx < 8; ++xx)
                blk[yy * 8 + xx] = p[yy * stride + xx];
        fdct8_islow(blk);
        int16_t* o = slot(base, sx, ctx);
        for (int i = 0; i < 64; ++i) {
            int32_t c = blk[i];
            int32_t mag = c < 0 ? -c : c;
            int32_t num = mag + q4[i];
            int32_t den = (int32_t)q8f[i];
            int32_t quot = (int32_t)__builtin_floorf((float)num / q8f[i]);
            int32_t rem = num - quot * den;
            if (rem < 0) quot -= 1;
            else if (rem >= den) quot += 1;
            o[i] = (int16_t)(c < 0 ? -quot : quot);
        }
    }
#endif
}

static int16_t* slot_raster(int16_t* base, int64_t sx, void* ctx) {
    (void)ctx;
    return base + sx * 64;
}
// Y block order inside a 420 MCU row: block column sx of half-row `half`
// lands at MCU (sx>>1), slot half*2 + (sx&1).
static int16_t* slot_mcu_y(int16_t* base, int64_t sx, void* ctx) {
    int64_t half = *(int64_t*)ctx;
    return base + (((sx >> 1) * 4) + half * 2 + (sx & 1)) * 64;
}

static int64_t quant_entropy_core_420(
    const uint8_t* rgba, int64_t h, int64_t w,
    const int32_t* lq, const int32_t* cq,
    int16_t* yout, int16_t* cbout, int16_t* crout,
    const HuffTable* luma, const HuffTable* chroma,
    EntropyState* st, uint8_t* out, int64_t capacity) {
    int32_t l4[64], c4[64];
    float l8f[64], c8f[64];
    for (int i = 0; i < 64; ++i) {
        l4[i] = 4 * lq[i];
        c4[i] = 4 * cq[i];
        l8f[i] = (float)(8 * lq[i]);
        c8f[i] = (float)(8 * cq[i]);
    }
#ifdef __AVX2__
    __m256i l4v[8], c4v[8], l8iv[8], c8iv[8];
    __m256 l8fv[8], c8fv[8];
    for (int r = 0; r < 8; ++r) {
        l4v[r] = _mm256_loadu_si256((const __m256i*)(l4 + r * 8));
        c4v[r] = _mm256_loadu_si256((const __m256i*)(c4 + r * 8));
        l8fv[r] = _mm256_loadu_ps(l8f + r * 8);
        c8fv[r] = _mm256_loadu_ps(c8f + r * 8);
        int32_t li[8], ci[8];
        for (int k = 0; k < 8; ++k) { li[k] = 8 * lq[r * 8 + k]; ci[k] = 8 * cq[r * 8 + k]; }
        l8iv[r] = _mm256_loadu_si256((const __m256i*)li);
        c8iv[r] = _mm256_loadu_si256((const __m256i*)ci);
    }
#if defined(__AVX512BW__) && defined(__AVX512DQ__)
    __m512i l4z[8], c4z[8];
    __m512 l8fz[8], c8fz[8];
    for (int r = 0; r < 8; ++r) {
        l4z[r] = _mm512_broadcast_i32x8(l4v[r]);
        c4z[r] = _mm512_broadcast_i32x8(c4v[r]);
        l8fz[r] = _mm512_broadcast_f32x8(l8fv[r]);
        c8fz[r] = _mm512_broadcast_f32x8(c8fv[r]);
    }
#endif
#endif
    int64_t bxl = w / 8;    // luma blocks per 8-row half
    int64_t bxc = w / 16;   // chroma blocks == MCUs per strip row
    int64_t wc = w / 2;     // chroma plane width
    // planes: y/cb/cr (16, w) + subsampled cbs/crs (8, w/2); fused mode
    // adds strip-local blocks (4+1+1) * bxc.
    size_t plane_elems = (size_t)(3 * 16 * w + 2 * 8 * wc);
    size_t scratch_elems = out ? (size_t)(6 * bxc * 64) : 0;
    int16_t* planes = (int16_t*)malloc(
        (plane_elems + scratch_elems) * sizeof(int16_t));
    int16_t* yp = planes;
    int16_t* cbp = planes + 16 * w;
    int16_t* crp = planes + 32 * w;
    int16_t* cbs = planes + 48 * w;
    int16_t* crs = cbs + 8 * wc;
    int16_t* ystrip = planes + plane_elems;
    int16_t* cbstrip = ystrip + 4 * bxc * 64;
    int16_t* crstrip = cbstrip + bxc * 64;
    uint8_t* p = out;
    const uint8_t* pend = out ? out + capacity : NULL;
    for (int64_t sy = 0; sy < h / 16; ++sy) {
        int16_t* ybase = out ? ystrip : yout + sy * bxc * 4 * 64;
        int16_t* cbbase = out ? cbstrip : cbout + sy * bxc * 64;
        int16_t* crbase = out ? crstrip : crout + sy * bxc * 64;
        const uint8_t* src = rgba + sy * 16 * w * 4;
        int64_t n = 16 * w;
        int64_t i = 0;
#if defined(__AVX512BW__) && defined(__AVX512DQ__)
        {
            // Same shufb+maddwd integer convert as the 444 core.
            const __m512i shuf_rg = _mm512_broadcast_i32x4(_mm_setr_epi8(
                0, -1, 1, -1, 4, -1, 5, -1, 8, -1, 9, -1, 12, -1, 13, -1));
            const __m512i shuf_gb = _mm512_broadcast_i32x4(_mm_setr_epi8(
                1, -1, 2, -1, 5, -1, 6, -1, 9, -1, 10, -1, 13, -1, 14, -1));
            const __m512i shuf_r = _mm512_broadcast_i32x4(_mm_setr_epi8(
                0, -1, -1, -1, 4, -1, -1, -1, 8, -1, -1, -1, 12, -1, -1, -1));
            const __m512i shuf_b = _mm512_broadcast_i32x4(_mm_setr_epi8(
                2, -1, -1, -1, 6, -1, -1, -1, 10, -1, -1, -1, 14, -1, -1, -1));
            const __m512i cy_rg = STITCH_PAIR16_Z(19595, 19235);
            const __m512i cy_gb = STITCH_PAIR16_Z(19235, 7471);
            const __m512i ccb_rg = STITCH_PAIR16_Z(-11059, -21709);
            const __m512i ccr_gb = STITCH_PAIR16_Z(-27439, -5329);
            const __m512i bias_y = _mm512_set1_epi32(32768 - (128 << 16));
            const __m512i bias_c = _mm512_set1_epi32(32768);
            for (; i + 16 <= n; i += 16) {
                __m512i v = _mm512_loadu_si512((const void*)(src + i * 4));
                __m512i rg = _mm512_shuffle_epi8(v, shuf_rg);
                __m512i gb = _mm512_shuffle_epi8(v, shuf_gb);
                __m512i r32 = _mm512_shuffle_epi8(v, shuf_r);
                __m512i b32 = _mm512_shuffle_epi8(v, shuf_b);
                __m512i ys = _mm512_add_epi32(
                    _mm512_add_epi32(_mm512_madd_epi16(rg, cy_rg),
                                     _mm512_madd_epi16(gb, cy_gb)),
                    bias_y);
                __m512i cbsv = _mm512_add_epi32(
                    _mm512_add_epi32(_mm512_madd_epi16(rg, ccb_rg),
                                     _mm512_slli_epi32(b32, 15)),
                    bias_c);
                __m512i crsv = _mm512_add_epi32(
                    _mm512_add_epi32(_mm512_madd_epi16(gb, ccr_gb),
                                     _mm512_slli_epi32(r32, 15)),
                    bias_c);
                _mm256_storeu_si256((__m256i*)(yp + i),
                    _mm512_cvtepi32_epi16(_mm512_srai_epi32(ys, 16)));
                _mm256_storeu_si256((__m256i*)(cbp + i),
                    _mm512_cvtepi32_epi16(_mm512_srai_epi32(cbsv, 16)));
                _mm256_storeu_si256((__m256i*)(crp + i),
                    _mm512_cvtepi32_epi16(_mm512_srai_epi32(crsv, 16)));
            }
        }
#endif
        for (; i < n; ++i) {
            int32_t r = src[i * 4 + 0];
            int32_t g = src[i * 4 + 1];
            int32_t b = src[i * 4 + 2];
            yp[i] = (int16_t)(((19595 * r + 38470 * g + 7471 * b + 32768) >> 16) - 128);
            cbp[i] = (int16_t)(((-11059 * r - 21709 * g + 32768 * b + 32768 + (128 << 16)) >> 16) - 128);
            crp[i] = (int16_t)(((32768 * r - 27439 * g - 5329 * b + 32768 + (128 << 16)) >> 16) - 128);
        }
        // 2x2 box-average chroma ((sum+2)>>2 on level-shifted samples).
        for (int row = 0; row < 8; ++row) {
            const int16_t* pr0;
            const int16_t* pr1;
            int16_t* o;
            for (int c = 0; c < 2; ++c) {
                const int16_t* plane = c ? crp : cbp;
                pr0 = plane + (int64_t)(2 * row) * w;
                pr1 = plane + (int64_t)(2 * row + 1) * w;
                o = (c ? crs : cbs) + (int64_t)row * wc;
                int64_t j = 0;
#if defined(__AVX512BW__) && defined(__AVX512DQ__)
                {
                    const __m512i ones = _mm512_set1_epi16(1);
                    const __m512i two = _mm512_set1_epi32(2);
                    for (; j + 32 <= w; j += 32) {
                        __m512i a = _mm512_loadu_si512((const void*)(pr0 + j));
                        __m512i b = _mm512_loadu_si512((const void*)(pr1 + j));
                        __m512i s = _mm512_add_epi32(
                            _mm512_add_epi32(_mm512_madd_epi16(a, ones),
                                             _mm512_madd_epi16(b, ones)),
                            two);
                        _mm256_storeu_si256((__m256i*)(o + j / 2),
                            _mm512_cvtepi32_epi16(_mm512_srai_epi32(s, 2)));
                    }
                }
#endif
                for (; j < w; j += 2)
                    o[j / 2] = (int16_t)(
                        (pr0[j] + pr0[j + 1] + pr1[j] + pr1[j + 1] + 2) >> 2);
            }
        }
        // Y: two 8-row halves, MCU [TL,TR,BL,BR] block order.
        for (int64_t half = 0; half < 2; ++half) {
            quant_plane_row(yp + half * 8 * w, w, bxl, ybase, 0, 0,
#ifdef __AVX2__
                            l4v, l8fv, l8iv,
#if defined(__AVX512BW__) && defined(__AVX512DQ__)
                            l4z, l8fz,
#endif
#endif
                            l4, l8f, slot_mcu_y, &half);
        }
        // Chroma blocks, raster order.
        quant_plane_row(cbs, wc, bxc, cbbase, 0, 0,
#ifdef __AVX2__
                        c4v, c8fv, c8iv,
#if defined(__AVX512BW__) && defined(__AVX512DQ__)
                        c4z, c8fz,
#endif
#endif
                        c4, c8f, slot_raster, NULL);
        quant_plane_row(crs, wc, bxc, crbase, 0, 0,
#ifdef __AVX2__
                        c4v, c8fv, c8iv,
#if defined(__AVX512BW__) && defined(__AVX512DQ__)
                        c4z, c8fz,
#endif
#endif
                        c4, c8f, slot_raster, NULL);
        if (out) {
            for (int64_t m = 0; m < bxc; ++m) {
                if (pend - p < 6 * kMaxBlockBytes) { free(planes); return -1; }
                for (int64_t j = 0; j < 4; ++j)
                    encode_block(st, &p, ybase + (m * 4 + j) * 64, luma, 0);
                encode_block(st, &p, cbbase + m * 64, chroma, 1);
                encode_block(st, &p, crbase + m * 64, chroma, 2);
            }
        }
    }
    free(planes);
    return out ? (int64_t)(p - out) : 0;
}

void jpeg_quant_band_420(const uint8_t* rgba, int64_t h, int64_t w,
                         const int32_t* lq, const int32_t* cq,
                         int16_t* yout, int16_t* cbout, int16_t* crout) {
    quant_entropy_core_420(rgba, h, w, lq, cq, yout, cbout, crout,
                           NULL, NULL, NULL, NULL, 0);
}

int64_t jpeg_quant_entropy_band_420(
    const uint8_t* rgba, int64_t h, int64_t w,
    const int32_t* lq, const int32_t* cq,
    const HuffTable* luma, const HuffTable* chroma,
    EntropyState* state, uint8_t* out, int64_t capacity) {
    return quant_entropy_core_420(rgba, h, w, lq, cq, NULL, NULL, NULL,
                                  luma, chroma, state, out, capacity);
}

// Flush remaining buffered bits (up to 57 with deferred flushing), final
// partial byte padded with 1s. Returns bytes written (0..16).
int64_t jpeg_entropy_flush(EntropyState* state, uint8_t* out) {
    uint8_t* p = out;
    drain_bytes(state, &p);
    if (state->count > 0) {
        int pad = 8 - (int)state->count;
        uint8_t byte =
            (uint8_t)((state->bits << pad) | ((1u << pad) - 1u));
        state->count = 0;
        state->bits = 0;
        *p++ = byte;
        if (byte == 0xFF) *p++ = 0x00;
    }
    state->bits = 0;
    return (int64_t)(p - out);
}

// ---------------------------------------------------------------------------
// Baseline JPEG Huffman scan decode (the owned decoder's hot loop).
//
// Marker parsing stays in Python (codecs/jpeg/owned_decoder.py); this walks
// the entropy-coded segment: canonical Huffman decode per T.81 F.2.2,
// 0xFF00 unstuffing, restart-marker resync, DC prediction, and the store:
// natural-order int32 blocks (the host tier), or zigzag-order int16 blocks
// with their bounds (the device tier's transport).
// ---------------------------------------------------------------------------

typedef struct {
    int32_t min_code[17];
    int32_t max_code[17];
    int32_t val_ptr[17];
    uint8_t vals[256];
} HuffDecTable;

// Buffered MSB-first bit reader: up to 64 bits live in `bb` (next bit is
// bit n-1). The refill prefetches WHOLE bytes only and never consumes a
// marker (0xFF followed by non-zero): it pins `pos` at the marker and
// feeds zero bits, which reproduces the byte-serial reader's semantics
// (T.81 segment-end zero feed) while allowing 8-byte bulk refills on the
// fast path (SWAR scan proves no 0xFF in the next 8 bytes).
typedef struct {
    const uint8_t* data;
    int64_t len;
    int64_t pos;
    uint64_t bb;
    int n;
} BitReader;

static inline void br_fill(BitReader* br) {
    if (br->n >= 56) return;
    if (br->pos + 8 <= br->len) {
        uint64_t be;
        memcpy(&be, br->data + br->pos, 8);
        // any byte == 0xFF?  (haszero over be ^ 0xFF...)
        uint64_t x = be ^ 0xFFFFFFFFFFFFFFFFull;
        if (!((x - 0x0101010101010101ull) & ~x & 0x8080808080808080ull)) {
            // At most 7 bytes so every shift below stays < 64 (m = 8 at
            // n == 0 would be bb << 64: UB, and x86's masked shift ORs
            // STALE consumed bits over the fresh ones — a desync found
            // by the progressive DC-refine parity fuzz, where 1-bit
            // takes drain n to exactly 0).
            const int m = (63 - br->n) >> 3;  // 1..7 bytes
            be = __builtin_bswap64(be);
            br->bb = (br->bb << (m * 8)) | (be >> (64 - m * 8));
            br->n += m * 8;
            br->pos += m;
            return;
        }
    }
    while (br->n <= 56) {
        uint8_t b = 0;
        if (br->pos < br->len) {
            b = br->data[br->pos];
            if (b == 0xFF) {
                uint8_t nxt =
                    br->pos + 1 < br->len ? br->data[br->pos + 1] : 0xD9;
                if (nxt == 0x00) {
                    br->pos += 2;
                } else {
                    b = 0;  // Marker: feed zeros, don't consume.
                }
            } else {
                br->pos += 1;
            }
        }
        br->bb = (br->bb << 8) | b;
        br->n += 8;
    }
}

// Caller must have >= count bits buffered (br_fill guarantees >= 57).
static inline int br_take(BitReader* br, int count) {
    if (count == 0) return 0;
    br->n -= count;
    return (int)((br->bb >> br->n) & ((1u << count) - 1));
}

static int br_sync_restart(BitReader* br) {
    // Discard buffered bits; `pos` never passes a marker (see br_fill),
    // so scanning forward from it finds the same restart marker the
    // byte-serial reader would.
    br->bb = 0;
    br->n = 0;
    while (br->pos + 1 < br->len) {
        if (br->data[br->pos] == 0xFF && br->data[br->pos + 1] >= 0xD0 &&
            br->data[br->pos + 1] <= 0xD7) {
            br->pos += 2;
            return 0;
        }
        br->pos += 1;
    }
    return -1;
}

// First-level 8-bit Huffman LUT: lut[peek8] = (symbol << 8) | code_len
// for codes of length <= 8 (>=99% of symbols on standard tables), 0 for
// longer codes (slow canonical walk). Built per scan from the same
// HuffDecTable the Python tier uses.
typedef struct {
    uint16_t lut[256];
} HuffFastLut;

static void build_fast_lut(const HuffDecTable* t, HuffFastLut* f) {
    memset(f->lut, 0, sizeof(f->lut));
    for (int length = 1; length <= 8; ++length) {
        if (t->max_code[length] < 0) continue;
        for (int32_t code = t->min_code[length]; code <= t->max_code[length];
             ++code) {
            int sym = t->vals[t->val_ptr[length] + code - t->min_code[length]];
            int lo = code << (8 - length);
            int hi = lo + (1 << (8 - length));
            for (int idx = lo; idx < hi; ++idx)
                f->lut[idx] = (uint16_t)((sym << 8) | length);
        }
    }
}

// Caller must have >= 16 bits buffered.
static inline int huff_decode(BitReader* br, const HuffDecTable* t,
                              const HuffFastLut* f) {
    const int peek8 = (int)((br->bb >> (br->n - 8)) & 0xFF);
    const uint16_t e = f->lut[peek8];
    if (e) {
        br->n -= e & 0xFF;
        return e >> 8;
    }
    int code = peek8;
    br->n -= 8;
    for (int length = 9; length <= 16; ++length) {
        code = (code << 1) | (int)((br->bb >> --br->n) & 1);
        if (t->max_code[length] >= 0 && code <= t->max_code[length] &&
            code >= t->min_code[length]) {
            return t->vals[t->val_ptr[length] + code - t->min_code[length]];
        }
    }
    return -1;
}

static inline int extend_val(int v, int size) {
    if (size == 0) return 0;
    return v >= (1 << (size - 1)) ? v : v - (1 << size) + 1;
}

}  // extern "C"

// The scan's coefficient stores. The loop below is a template over them, so
// each entry point compiles the loop for its own store alone.
//
// NaturalStore: (by*bx, 64) int32 blocks in natural order, zeroed by the
// caller; each coefficient is de-zigzagged as it is stored. The host
// tier's decode (jpeg_decode_scan).
struct NaturalStore {
    int32_t* base[3];
    int32_t* blk;
    inline void begin(int c, int64_t block) { blk = base[c] + block * 64; }
    inline void dc(int, int v) { blk[0] = v; }
    inline void ac(int, int k, int v) { blk[kZigzag[k]] = v; }
    inline void end(int) {}
};

// ZigzagStore: (by*bx, 64) int16 blocks in zigzag order, the device tier's
// transport (jpeg_decode_scan_zigzag). The buffers need no zeroing: a
// block is cleared when the scan reaches it. Per scan component it keeps
// the highest nonzero zigzag position (-1: none) and the peak |value|; a
// value past int16 is stored truncated, and the peak tells the caller so.
struct ZigzagStore {
    int16_t* base[3];
    int16_t* blk;
    int last;  // the block's highest nonzero zigzag position
    int comp_last[3];
    int64_t comp_peak[3];
    inline void begin(int c, int64_t block) {
        blk = base[c] + block * 64;
        memset(blk, 0, 64 * sizeof(int16_t));
        last = -1;
    }
    inline void dc(int c, int v) {
        blk[0] = (int16_t)v;
        if (v) last = 0;
        const int64_t a = v < 0 ? -(int64_t)v : (int64_t)v;
        if (a > comp_peak[c]) comp_peak[c] = a;
    }
    // v != 0: an AC value the code carries has a size of 1 to 15 bits.
    inline void ac(int c, int k, int v) {
        blk[k] = (int16_t)v;
        last = k;
        const int64_t a = v < 0 ? -(int64_t)v : (int64_t)v;
        if (a > comp_peak[c]) comp_peak[c] = a;
    }
    inline void end(int c) {
        if (last > comp_last[c]) comp_last[c] = last;
    }
};

// Returns 0 on success, negative error otherwise.
// comp_wb/comp_hb: per-component true block-grid bounds. A scan with ONE
// component is non-interleaved (T.81 A.2 / libjpeg jdinput.c): data unit
// = one block over the component's own (hb, wb) grid — no h x v MCU
// grouping, no padding columns — and restart_interval counts BLOCKS.
template <typename Store>
static int decode_scan(const uint8_t* data, int64_t data_len,
                       int n_comps, const int* comp_h, const int* comp_v,
                       const int* comp_bx, const int* comp_wb, const int* comp_hb,
                       const HuffDecTable* dc_tables, const HuffDecTable* ac_tables,
                       const int* dc_sel, const int* ac_sel,
                       int mcux, int mcuy, int restart_interval, Store& store) {
    if (n_comps == 1) {
        mcux = comp_wb[0];
        mcuy = comp_hb[0];
    }
    int32_t preds[3] = {0, 0, 0};
    BitReader br = {data, data_len, 0, 0, 0};
    int64_t mcu_count = 0;

    HuffFastLut dc_luts[4], ac_luts[4];
    int built_dc[4] = {0, 0, 0, 0}, built_ac[4] = {0, 0, 0, 0};
    for (int c = 0; c < n_comps; ++c) {
        const int d = dc_sel[c], a = ac_sel[c];
        if (d < 0 || d > 3 || a < 0 || a > 3) return -6;
        if (!built_dc[d]) { build_fast_lut(dc_tables + d, &dc_luts[d]); built_dc[d] = 1; }
        if (!built_ac[a]) { build_fast_lut(ac_tables + a, &ac_luts[a]); built_ac[a] = 1; }
    }

    for (int my = 0; my < mcuy; ++my) {
        for (int mx = 0; mx < mcux; ++mx) {
            if (restart_interval && mcu_count &&
                mcu_count % restart_interval == 0) {
                if (br_sync_restart(&br) != 0) return -2;
                preds[0] = preds[1] = preds[2] = 0;
            }
            for (int c = 0; c < n_comps; ++c) {
                const HuffDecTable* dct = dc_tables + dc_sel[c];
                const HuffDecTable* act = ac_tables + ac_sel[c];
                const HuffFastLut* dcf = &dc_luts[dc_sel[c]];
                const HuffFastLut* acf = &ac_luts[ac_sel[c]];
                const int nv = n_comps == 1 ? 1 : comp_v[c];
                const int nh = n_comps == 1 ? 1 : comp_h[c];
                for (int v = 0; v < nv; ++v) {
                    for (int h = 0; h < nh; ++h) {
                        int bx = mx * nh + h;
                        int by = my * nv + v;
                        store.begin(c, (int64_t)by * comp_bx[c] + bx);
                        // 32 buffered bits cover code (<=16) +
                        // magnitude (<=16); refilling only below that
                        // halves refill frequency (bulk refills insert
                        // up to 7 bytes each).
                        if (br.n < 32) br_fill(&br);
                        int s = huff_decode(&br, dct, dcf);
                        if (s < 0 || s > 16) return -3;
                        int diff = extend_val(br_take(&br, s), s);
                        preds[c] += diff;
                        store.dc(c, preds[c]);
                        int k = 1;
                        while (k < 64) {
                            if (br.n < 32) br_fill(&br);
                            int rs = huff_decode(&br, act, acf);
                            if (rs < 0) return -4;
                            int r = rs >> 4, size = rs & 0x0F;
                            if (size == 0) {
                                if (r == 15) { k += 16; continue; }
                                break;  // EOB
                            }
                            k += r;
                            if (k > 63) return -5;
                            store.ac(c, k, extend_val(br_take(&br, size), size));
                            k += 1;
                        }
                        store.end(c);
                    }
                }
            }
            ++mcu_count;
        }
    }
    return 0;
}

extern "C" {

// blocks0..2: per scan component, (by*bx, 64) int32 zeroed.
int jpeg_decode_scan(const uint8_t* data, int64_t data_len,
                     int n_comps, const int* comp_h, const int* comp_v,
                     const int* comp_bx, const int* comp_wb, const int* comp_hb,
                     const HuffDecTable* dc_tables, const HuffDecTable* ac_tables,
                     const int* dc_sel, const int* ac_sel,
                     int mcux, int mcuy, int restart_interval,
                     int32_t* blocks0, int32_t* blocks1, int32_t* blocks2) {
    NaturalStore store = {{blocks0, blocks1, blocks2}, nullptr};
    return decode_scan(data, data_len, n_comps, comp_h, comp_v, comp_bx, comp_wb,
                       comp_hb, dc_tables, ac_tables, dc_sel, ac_sel, mcux, mcuy,
                       restart_interval, store);
}

// The same scan into ZigzagStore. blocks0..2: per scan component,
// (comp_by*bx, 64) int16, any content: every block of the component comes
// back written, the MCU padding a non-interleaved scan does not visit
// zeroed here. stats: per scan component (last, peak) as int64, written on
// success. next_marker: the offset in data of the first marker that is not
// a restart marker (data_len if none), where the marker walk goes on. The
// search starts at the scan's start, not where the reader stopped: a
// restart resync skips any other marker it meets.
int jpeg_decode_scan_zigzag(const uint8_t* data, int64_t data_len,
                            int n_comps, const int* comp_h, const int* comp_v,
                            const int* comp_bx, const int* comp_wb, const int* comp_hb,
                            const int* comp_by,
                            const HuffDecTable* dc_tables, const HuffDecTable* ac_tables,
                            const int* dc_sel, const int* ac_sel,
                            int mcux, int mcuy, int restart_interval,
                            int16_t* blocks0, int16_t* blocks1, int16_t* blocks2,
                            int64_t* stats, int64_t* next_marker) {
    ZigzagStore store = {{blocks0, blocks1, blocks2}, nullptr, -1,
                         {-1, -1, -1}, {0, 0, 0}};
    const int rc = decode_scan(data, data_len, n_comps, comp_h, comp_v, comp_bx,
                               comp_wb, comp_hb, dc_tables, ac_tables, dc_sel,
                               ac_sel, mcux, mcuy, restart_interval, store);
    if (rc != 0) return rc;
    *next_marker = data_len;
    for (int64_t p = 0; p + 1 < data_len; ++p) {
        const uint8_t* ff = (const uint8_t*)memchr(data + p, 0xFF, (size_t)(data_len - 1 - p));
        if (ff == nullptr) break;
        p = ff - data;
        const uint8_t nxt = data[p + 1];
        if (nxt != 0x00 && (nxt < 0xD0 || nxt > 0xD7)) {
            *next_marker = p;
            break;
        }
    }
    if (n_comps == 1) {
        const int64_t bx = comp_bx[0], wb = comp_wb[0], hb = comp_hb[0];
        for (int64_t by = 0; by < comp_by[0]; ++by) {
            const int64_t from = by < hb ? wb : 0;
            if (from < bx)
                memset(blocks0 + (by * bx + from) * 64, 0,
                       (size_t)(bx - from) * 64 * sizeof(int16_t));
        }
    }
    for (int c = 0; c < n_comps; ++c) {
        stats[2 * c] = store.comp_last[c];
        stats[2 * c + 1] = store.comp_peak[c];
    }
    return 0;
}

// dst (n, k) int16: the first k (8..64, a multiple of 8) coefficients of
// each of the n zigzag-order blocks of src (n, 64).
void jpeg_zigzag_prefix(const int16_t* src, int16_t* dst, int64_t n, int k) {
    for (int64_t i = 0; i < n; ++i) {
        const int16_t* s = src + i * 64;
        int16_t* d = dst + i * k;
        for (int j = 0; j < k; j += 8) memcpy(d + j, s + j, 8 * sizeof(int16_t));
    }
}

}  // extern "C"

extern "C" {

// ---------------------------------------------------------------------------
// Owned streaming inflate (RFC 1950/1951) — replaces runtime zlib on the
// decode hot path (SURVEY §2 native item 2). Design: flat 15-bit decode
// tables (one load per symbol, no subtable indirection; build cost is
// exactly 2^15 writes per table per dynamic block, ~0.3% of decode time),
// 64-bit branchless bit-buffer refills, and full suspend/resume at any
// input/output boundary so the PNG band decoder keeps O(width) memory.
// Adler-32 is not verified (PNG integrity is covered by per-chunk CRC-32 in
// strict mode); the stream is parsed to its exact end so residual-data
// checks still work.
// ---------------------------------------------------------------------------

// Two-level decode tables: an L1-resident root (11 bits lit/len, 8 bits
// distance) plus per-pattern subtables for the rare codes longer than the
// root (libdeflate-style). One load for short codes, two for long ones.
#define INFL_LL_ROOT 11
#define INFL_D_ROOT 10
#define INFL_LL_CAP ((1 << INFL_LL_ROOT) + 2048)
#define INFL_D_CAP ((1 << INFL_D_ROOT) + 2048)

// Table entry: bits 0-4 = consumed bits (code length — total incl. root
// bits for subtable entries — plus, for LEN entries, the extra bits, so
// the hot loop advances the bit buffer with one shift); bits 5-7 = kind;
// bits 8-31 = payload (LEN: base(16) | code_len(5)<<16; the extra-bits
// field is (saved >> code_len) & ((1 << (consumed-code_len)) - 1)).
// LIT/LIT2/LIT3 are kept
// contiguous from 0 so "kind <= INFL_K_LIT3" tests literal-ness and
// "kind + 1" is the literal count; LIT2/LIT3 pack 2-3 whole literal codes
// that fit together inside the root index (common on filtered-PNG streams,
// where mean code length is ~3 bits) — one table load emits up to 3 bytes.
#define INFL_K_LIT 0u
#define INFL_K_LIT2 1u
#define INFL_K_LIT3 2u
#define INFL_K_LEN 3u
#define INFL_K_EOB 4u
#define INFL_K_BAD 5u
#define INFL_K_SUB 6u
#define INFL_ENTRY(kind, nbits, payload) \
    ((uint32_t)(nbits) | ((kind) << 5) | ((uint32_t)(payload) << 8))
#define INFL_NBITS(e) ((e) & 31u)
#define INFL_KIND(e) (((e) >> 5) & 7u)
#define INFL_PAYLOAD(e) ((e) >> 8)

// Resolve a (possibly two-level) lookup. The returned entry's NBITS is the
// full code length; the caller must verify NBITS <= bitcount before trusting
// it (prefix-code property), and treat BAD as conclusive only with >= 15
// live bits.
#define INFL_LIKELY(x) __builtin_expect(!!(x), 1)
#define INFL_UNLIKELY(x) __builtin_expect(!!(x), 0)

static inline uint32_t infl_lookup(const uint32_t* tbl, uint64_t bitbuf,
                                   int rootbits) {
    uint32_t e = tbl[bitbuf & ((1u << rootbits) - 1u)];
    if (INFL_KIND(e) == INFL_K_SUB) {
        uint32_t subbits = INFL_NBITS(e);
        e = tbl[INFL_PAYLOAD(e) +
                ((bitbuf >> rootbits) & ((1u << subbits) - 1u))];
    }
    return e;
}

typedef struct InflState {
    uint64_t bitbuf;
    int32_t bitcount;
    int64_t in_pos;       // cursor into the caller-accreted input buffer
    int32_t state;        // 0 zhdr, 1 blkhdr, 2 stored, 3 huff, 4 adler, 5 done
    int32_t final_block;
    int64_t stored_left;
    int32_t pending_len;  // suspended match
    int32_t pending_dist;
    int32_t window_len;
    int64_t total_out;
    int32_t error;        // sticky error code (negative)
    int32_t pend_lit_count;  // literals decoded past a full output buffer
    uint8_t pend_lit[4];
    uint32_t stream_adler;  // trailer Adler-32 once state >= 5
    uint32_t litlen[INFL_LL_CAP];
    uint32_t dist[INFL_D_CAP];
    uint8_t window[32768];
} InflState;

static const uint16_t kLenBase[29] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31,
    35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
static const uint8_t kLenExtra[29] = {
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2,
    3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
static const uint16_t kDistBase[30] = {
    1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193,
    257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145,
    8193, 12289, 16385, 24577};
static const uint8_t kDistExtra[30] = {
    0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6,
    7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
static const uint8_t kClOrder[19] = {
    16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};

// Build a two-level LSB-indexed table from canonical code lengths.
// Returns 0, or -1 for an over-subscribed/invalid code.
static int infl_build_table(const uint8_t* lens, int n, uint32_t* table,
                            int table_cap, int rootbits, int is_litlen) {
    int count[16] = {0};
    for (int i = 0; i < n; ++i) count[lens[i]]++;
    count[0] = 0;
    int64_t left = 1 << 15;
    int used = 0;
    for (int l = 1; l <= 15; ++l) {
        left -= (int64_t)count[l] << (15 - l);
        if (left < 0) return -1;  // over-subscribed
        used += count[l];
    }
    const uint32_t bad = INFL_ENTRY(INFL_K_BAD, 0, 0);
    int rootsize = 1 << rootbits;
    for (int i = 0; i < rootsize; ++i) table[i] = bad;
    if (used == 0) return 0;  // empty code: any use hits BAD
    int next_code[16];
    int code = 0;
    for (int l = 1; l <= 15; ++l) {
        code = (code + count[l - 1]) << 1;
        next_code[l] = code;
    }
    // Pass 1: size the subtables (max code length per root pattern).
    int sub_bits[1 << INFL_LL_ROOT];
    int sub_off[1 << INFL_LL_ROOT];
    memset(sub_bits, 0, sizeof(int) * (size_t)rootsize);
    {
        int nc[16];
        memcpy(nc, next_code, sizeof nc);
        for (int sym = 0; sym < n; ++sym) {
            int len = lens[sym];
            if (!len) continue;
            int c = nc[len]++;
            if (len <= rootbits) continue;
            uint32_t rev = 0;
            for (int b = 0; b < len; ++b)
                rev |= (uint32_t)((c >> b) & 1) << (len - 1 - b);
            int r = (int)(rev & (uint32_t)(rootsize - 1));
            if (len - rootbits > sub_bits[r]) sub_bits[r] = len - rootbits;
        }
    }
    int sub_next = rootsize;
    for (int r = 0; r < rootsize; ++r) {
        if (!sub_bits[r]) continue;
        sub_off[r] = sub_next;
        sub_next += 1 << sub_bits[r];
        if (sub_next > table_cap) return -1;
        for (int i = sub_off[r]; i < sub_next; ++i) table[i] = bad;
        table[r] = INFL_ENTRY(INFL_K_SUB, sub_bits[r], sub_off[r]);
    }
    // Pass 2: fill entries.
    for (int sym = 0; sym < n; ++sym) {
        int len = lens[sym];
        if (!len) continue;
        int c = next_code[len]++;
        uint32_t rev = 0;
        for (int b = 0; b < len; ++b)
            rev |= (uint32_t)((c >> b) & 1) << (len - 1 - b);
        uint32_t entry;
        // LEN entries (both length and distance codes): NBITS holds the
        // TOTAL consumed bits (code + extra, <= 20 for lengths, <= 28 for
        // distances) so the hot loop advances the bit buffer with ONE
        // shift per symbol; payload packs base(16) | code_len(5)<<16 —
        // the extra-bits field is extracted off the critical chain from a
        // saved copy as (saved >> code_len) & ((1 << (total-code_len))-1)
        // (libdeflate-style; the old base|extra<<16 layout kept two
        // dependent shifts plus the extract on the serial bb chain).
        if (!is_litlen) {
            if (sym >= 30) return -1;
            entry = INFL_ENTRY(INFL_K_LEN, len + kDistExtra[sym],
                               (uint32_t)kDistBase[sym] |
                                   ((uint32_t)len << 16));
        } else if (sym < 256) {
            entry = INFL_ENTRY(INFL_K_LIT, len, sym);
        } else if (sym == 256) {
            entry = INFL_ENTRY(INFL_K_EOB, len, 0);
        } else {
            if (sym >= 286) return -1;
            entry = INFL_ENTRY(INFL_K_LEN, len + kLenExtra[sym - 257],
                               (uint32_t)kLenBase[sym - 257] |
                                   ((uint32_t)len << 16));
        }
        if (len <= rootbits) {
            for (uint32_t idx = rev; idx < (uint32_t)rootsize; idx += 1u << len)
                table[idx] = entry;
        } else {
            int r = (int)(rev & (uint32_t)(rootsize - 1));
            uint32_t high = rev >> rootbits;  // len-rootbits bits
            uint32_t span = 1u << sub_bits[r];
            for (uint32_t idx = high; idx < span; idx += 1u << (len - rootbits))
                table[sub_off[r] + idx] = entry;
        }
    }
    return 0;
}

// Root-table post-pass: where 2-3 complete literal codes fit inside one
// root index, replace the first literal's entry with a packed LIT2/LIT3
// entry (payload = literals little-endian, nbits = combined length). The
// prefix property makes this sound: an entry at index (idx >> consumed) is
// trusted only when its code length fits the remaining root bits, so the
// decode depends only on true stream bits. Reads from a snapshot — packing
// in place would block extensions through already-packed shorter indices.
static void infl_pack_multilits(uint32_t* table) {
    const int rootsize = 1 << INFL_LL_ROOT;
    uint32_t snap[1 << INFL_LL_ROOT];
    memcpy(snap, table, sizeof snap);
    for (int idx = 0; idx < rootsize; ++idx) {
        uint32_t e = snap[idx];
        if (INFL_KIND(e) != INFL_K_LIT) continue;
        uint32_t total = INFL_NBITS(e);
        uint32_t payload = INFL_PAYLOAD(e) & 0xFFu;
        uint32_t cnt = 1;
        while (cnt < 3) {
            uint32_t e2 = snap[idx >> total];
            if (INFL_KIND(e2) != INFL_K_LIT) break;
            uint32_t nb2 = INFL_NBITS(e2);
            if (total + nb2 > INFL_LL_ROOT) break;
            payload |= (INFL_PAYLOAD(e2) & 0xFFu) << (8 * cnt);
            total += nb2;
            ++cnt;
        }
        if (cnt > 1)
            table[idx] = INFL_ENTRY(cnt == 2 ? INFL_K_LIT2 : INFL_K_LIT3,
                                    total, payload);
    }
}

static void infl_build_fixed(InflState* st) {
    uint8_t lens[288];
    for (int i = 0; i < 144; ++i) lens[i] = 8;
    for (int i = 144; i < 256; ++i) lens[i] = 9;
    for (int i = 256; i < 280; ++i) lens[i] = 7;
    for (int i = 280; i < 288; ++i) lens[i] = 8;
    infl_build_table(lens, 288, st->litlen, INFL_LL_CAP, INFL_LL_ROOT, 1);
    infl_pack_multilits(st->litlen);
    uint8_t dlens[30];
    for (int i = 0; i < 30; ++i) dlens[i] = 5;
    infl_build_table(dlens, 30, st->dist, INFL_D_CAP, INFL_D_ROOT, 0);
}

static inline void infl_refill(InflState* st, const uint8_t* in, int64_t in_len) {
    if (in_len - st->in_pos >= 8) {
        uint64_t w;
        memcpy(&w, in + st->in_pos, 8);  // little-endian host
        st->bitbuf |= w << st->bitcount;
        st->in_pos += (63 - st->bitcount) >> 3;
        st->bitcount |= 56;
    } else {
        while (st->bitcount <= 56 && st->in_pos < in_len) {
            st->bitbuf |= (uint64_t)in[st->in_pos++] << st->bitcount;
            st->bitcount += 8;
        }
    }
}

static inline int infl_have(InflState* st, const uint8_t* in, int64_t in_len,
                            int nbits) {
    if (st->bitcount >= nbits) return 1;
    infl_refill(st, in, in_len);
    return st->bitcount >= nbits;
}

static inline uint32_t infl_take(InflState* st, int nbits) {
    uint32_t v = (uint32_t)(st->bitbuf & ((1ull << nbits) - 1ull));
    st->bitbuf >>= nbits;
    st->bitcount -= nbits;
    return v;
}

// Finish a match whose length was decoded but whose distance bits hadn't
// arrived (pending_len < 0). Returns 0 when resolved or parked again.
static int infl_resolve_pending_dist(InflState* st, const uint8_t* in,
                                     int64_t in_len, uint8_t* out,
                                     uint8_t** opp, uint8_t* oend) {
    if (st->pending_len >= 0) return 0;
    int32_t length = -st->pending_len;
    st->pending_len = 0;
    infl_refill(st, in, in_len);
    uint32_t de = infl_lookup(st->dist, st->bitbuf, INFL_D_ROOT);
    if (INFL_KIND(de) == INFL_K_BAD && st->bitcount >= 15) { st->error = -8; return -8; }
    // NBITS(de) is the TOTAL consume (code + extra); payload packs
    // base(16) | code_len(5)<<16 (see infl_build_table).
    if (INFL_KIND(de) != INFL_K_BAD &&
        st->bitcount >= (int32_t)INFL_NBITS(de)) {
        uint64_t saved = st->bitbuf;
        uint32_t dtotal = INFL_NBITS(de);
        uint32_t dp = INFL_PAYLOAD(de);
        uint32_t dcl = dp >> 16;
        infl_take(st, (int)dtotal);
        int32_t dist =
            (int32_t)(dp & 0xFFFFu) +
            (int32_t)((saved >> dcl) & ((1ull << (dtotal - dcl)) - 1ull));
        if ((uint64_t)dist > st->total_out + (uint64_t)(*opp - out)) {
            st->error = -9;
            return -9;
        }
        st->pending_len = length;
        st->pending_dist = dist;
        uint8_t* op = *opp;
        while (st->pending_len > 0 && op < oend) {
            int64_t produced = op - out;
            uint8_t byte;
            if (st->pending_dist <= produced) {
                byte = *(op - st->pending_dist);
            } else {
                int32_t widx =
                    st->window_len - (int32_t)(st->pending_dist - produced);
                if (widx < 0) { st->error = -10; return -10; }
                byte = st->window[widx];
            }
            *op++ = byte;
            st->pending_len--;
        }
        *opp = op;
    } else {
        st->pending_len = -length;  // still waiting for input
    }
    return 0;
}

void owned_inflate_init(InflState* st) {
    memset(st, 0, (size_t)((uint8_t*)st->litlen - (uint8_t*)st));
    st->window_len = 0;
}

// Decode as much as possible. Returns bytes written to out (>= 0), with
// st->state == 5 when the stream is complete and st->error < 0 on a
// malformed stream. Suspends (returns early) when input runs dry or the
// output buffer fills; call again with more input / fresh output.
int64_t owned_inflate(const uint8_t* in, int64_t in_len, InflState* st,
                      uint8_t* out, int64_t out_cap) {
    if (st->error) return st->error;
    uint8_t* op = out;
    uint8_t* oend = out + out_cap;

#define FAIL(code) do { st->error = (code); return (code); } while (0)

    // Drain literals decoded past the previous call's output boundary.
    if (st->pend_lit_count > 0) {
        int i = 0;
        while (i < st->pend_lit_count && op < oend) *op++ = st->pend_lit[i++];
        if (i < st->pend_lit_count) {
            memmove(st->pend_lit, st->pend_lit + i,
                    (size_t)(st->pend_lit_count - i));
            st->pend_lit_count -= i;
            goto suspend;  // output full again; window roll still applies
        }
        st->pend_lit_count = 0;
    }

    if (st->pending_len < 0) {
        int rc = infl_resolve_pending_dist(st, in, in_len, out, &op, oend);
        if (rc < 0) return rc;
        if (st->pending_len < 0) return 0;  // still input-starved
    }

    // Resume a suspended match copy first.
    while (st->pending_len > 0 && op < oend) {
        int64_t produced = op - out;
        int32_t dist = st->pending_dist;
        uint8_t byte;
        if (dist <= produced) {
            byte = *(op - dist);
        } else {
            int32_t widx = st->window_len - (int32_t)(dist - produced);
            if (widx < 0) FAIL(-10);
            byte = st->window[widx];
        }
        *op++ = byte;
        st->pending_len--;
    }
    // Output full with the match still unfinished: decoding further symbols
    // now would clobber pending_len/pending_dist and drop the remaining
    // match bytes (corruption seen with sub-match-length output buffers).
    if (st->pending_len > 0) goto suspend;

    for (;;) {
        if (st->state == 0) {  // zlib header
            if (!infl_have(st, in, in_len, 16)) break;
            uint32_t cmf = infl_take(st, 8);
            uint32_t flg = infl_take(st, 8);
            if ((cmf & 0x0F) != 8) FAIL(-2);
            if (((cmf << 8) | flg) % 31 != 0) FAIL(-3);
            if (flg & 0x20) FAIL(-4);  // FDICT unsupported
            st->state = 1;
        } else if (st->state == 1) {  // block header
            // Snapshot before consuming ANY header bits: a suspension
            // anywhere in the (possibly long, dynamic) header rewinds to
            // here and re-parses when more input arrives.
            uint64_t save_buf = st->bitbuf;
            int32_t save_cnt = st->bitcount;
            int64_t save_pos = st->in_pos;
            int32_t save_final = st->final_block;
            if (!infl_have(st, in, in_len, 3)) break;
            st->final_block = (int32_t)infl_take(st, 1);
            uint32_t btype = infl_take(st, 2);
            if (btype == 0) {
                infl_take(st, st->bitcount & 7);  // byte align
                if (!infl_have(st, in, in_len, 32)) goto hdr_suspend;
                uint32_t len = infl_take(st, 16);
                uint32_t nlen = infl_take(st, 16);
                if ((len ^ nlen) != 0xFFFF) FAIL(-5);
                st->stored_left = len;
                st->state = 2;
            } else if (btype == 1) {
                infl_build_fixed(st);
                st->state = 3;
            } else if (btype == 2) {
                // Dynamic header: demand the whole header, else rewind.
                if (!infl_have(st, in, in_len, 14)) { goto hdr_suspend; }
                {
                uint32_t hlit = infl_take(st, 5) + 257;
                uint32_t hdist = infl_take(st, 5) + 1;
                uint32_t hclen = infl_take(st, 4) + 4;
                if (hlit > 286 || hdist > 30) FAIL(-6);
                uint8_t cl_lens[19];
                memset(cl_lens, 0, sizeof cl_lens);
                for (uint32_t i = 0; i < hclen; ++i) {
                    if (!infl_have(st, in, in_len, 3)) goto hdr_suspend;
                    cl_lens[kClOrder[i]] = (uint8_t)infl_take(st, 3);
                }
                uint32_t cl_table[128];
                {
                    // Small flat table for the 7-bit code-length code.
                    int count[8] = {0};
                    for (int i = 0; i < 19; ++i) count[cl_lens[i]]++;
                    count[0] = 0;
                    int left = 1 << 7;
                    for (int l = 1; l <= 7; ++l) left -= count[l] << (7 - l);
                    if (left < 0) FAIL(-6);
                    for (int i = 0; i < 128; ++i)
                        cl_table[i] = INFL_ENTRY(INFL_K_BAD, 0, 0);
                    int next_code[8];
                    int code = 0;
                    for (int l = 1; l <= 7; ++l) {
                        code = (code + count[l - 1]) << 1;
                        next_code[l] = code;
                    }
                    for (int sym = 0; sym < 19; ++sym) {
                        int len = cl_lens[sym];
                        if (!len) continue;
                        int c = next_code[len]++;
                        uint32_t rev = 0;
                        for (int b = 0; b < len; ++b)
                            rev |= (uint32_t)((c >> b) & 1) << (len - 1 - b);
                        for (uint32_t idx = rev; idx < 128; idx += 1u << len)
                            cl_table[idx] = INFL_ENTRY(INFL_K_LIT, len, sym);
                    }
                }
                uint8_t lens[286 + 30];
                uint32_t total = hlit + hdist;
                uint32_t li = 0;
                while (li < total) {
                    if (!infl_have(st, in, in_len, 7 + 7)) goto hdr_suspend;
                    uint32_t e = cl_table[st->bitbuf & 127];
                    if (INFL_KIND(e) == INFL_K_BAD) FAIL(-6);
                    infl_take(st, (int)INFL_NBITS(e));
                    uint32_t sym = INFL_PAYLOAD(e);
                    if (sym < 16) {
                        lens[li++] = (uint8_t)sym;
                    } else if (sym == 16) {
                        if (li == 0) FAIL(-6);
                        uint32_t rep = 3 + infl_take(st, 2);
                        if (li + rep > total) FAIL(-6);
                        uint8_t prev = lens[li - 1];
                        while (rep--) lens[li++] = prev;
                    } else if (sym == 17) {
                        uint32_t rep = 3 + infl_take(st, 3);
                        if (li + rep > total) FAIL(-6);
                        while (rep--) lens[li++] = 0;
                    } else {
                        uint32_t rep = 11 + infl_take(st, 7);
                        if (li + rep > total) FAIL(-6);
                        while (rep--) lens[li++] = 0;
                    }
                }
                if (lens[256] == 0) FAIL(-6);  // EOB must exist
                if (infl_build_table(lens, (int)hlit, st->litlen,
                                     INFL_LL_CAP, INFL_LL_ROOT, 1)) FAIL(-6);
                infl_pack_multilits(st->litlen);
                if (infl_build_table(lens + hlit, (int)hdist, st->dist,
                                     INFL_D_CAP, INFL_D_ROOT, 0)) FAIL(-6);
                st->state = 3;
                }
                continue;
            hdr_suspend:
                st->bitbuf = save_buf;
                st->bitcount = save_cnt;
                st->in_pos = save_pos;
                st->final_block = save_final;
                st->state = 1;
                break;
            } else {
                FAIL(-5);
            }
        } else if (st->state == 2) {  // stored block
            // Drain buffered whole bytes first, then bulk memcpy.
            while (st->stored_left > 0 && st->bitcount >= 8 && op < oend) {
                *op++ = (uint8_t)infl_take(st, 8);
                st->stored_left--;
            }
            // The branchless refill leaves valid-but-uncounted bits above
            // bitcount that mirror bytes at in_pos. Advancing in_pos by
            // memcpy (bypassing the bit reader) would desynchronize them:
            // mask the buffer down to the counted bits first.
            st->bitbuf &= st->bitcount ? ((1ull << st->bitcount) - 1ull) : 0ull;
            int64_t n = st->stored_left;
            if (n > in_len - st->in_pos) n = in_len - st->in_pos;
            if (n > oend - op) n = oend - op;
            if (n > 0) {
                memcpy(op, in + st->in_pos, (size_t)n);
                op += n;
                st->in_pos += n;
                st->stored_left -= n;
            }
            if (st->stored_left > 0) break;  // out of input or output
            st->state = st->final_block ? 4 : 1;
        } else if (st->state == 3) {  // huffman block
            // Fast path: with >= 8 input bytes and >= 300 output bytes,
            // one branchless refill guarantees a full worst-case symbol
            // sequence (2 literals, or a whole match incl. a second refill
            // for the distance), so no suspension checks are needed.
            //
            // The bit-reader state is cached in locals for the duration of
            // the loop: output stores go through uint8_t* (which aliases
            // everything), so keeping bitbuf/bitcount in st-> would force
            // the compiler to reload them around every *op++ store.
            // FAIL exits sync nothing (error is sticky and terminal); every
            // other exit syncs through INFL_FAST_SYNC.
            uint32_t e_pre = 0;
            int have_pre = 0;
            {
                uint64_t bb = st->bitbuf;
                int32_t bc = st->bitcount;
                const uint8_t* ip = in + st->in_pos;
                // Integer form on purpose: `in + in_len - 8` underflows when
                // the caller passes in == NULL with in_len == 0 (empty
                // accreted buffer right after compaction).
                int64_t in_left = in_len - st->in_pos;
                const uint32_t* const lltab = st->litlen;
                const uint32_t* const dtab = st->dist;
                const uint64_t prior_out = (uint64_t)st->total_out;
#define INFL_FAST_SYNC()                 \
    do {                                 \
        st->bitbuf = bb;                 \
        st->bitcount = bc;               \
        st->in_pos = (int64_t)(ip - in); \
    } while (0)
            for (;;) {
                if (INFL_UNLIKELY(in_left < 8 || oend - op < 300)) break;
                {   // branchless refill: bc >= 56 after
                    uint64_t w;
                    memcpy(&w, ip, 8);  // little-endian host
                    bb |= w << bc;
                    int64_t adv = (63 - bc) >> 3;
                    ip += adv;
                    in_left -= adv;
                    bc |= 56;
                }
                uint32_t e = have_pre
                                 ? e_pre
                                 : lltab[bb & ((1u << INFL_LL_ROOT) - 1u)];
                if (!have_pre && INFL_KIND(e) == INFL_K_SUB)
                    e = lltab[INFL_PAYLOAD(e) +
                              ((bb >> INFL_LL_ROOT) &
                               ((1u << INFL_NBITS(e)) - 1u))];
                have_pre = 0;
                uint32_t kind = INFL_KIND(e);
                // Literal burst: one lookup emits 1-3 bytes (packed
                // multi-literal root entries); entries consume at most
                // 10 root bits or a 15-bit long code. Budget 8: the bc >=
                // NBITS check bounds bit use, and 8 iterations x 3 bytes +
                // the 274-byte worst-case match overshoot = 298 stays
                // inside the 300-byte output margin (4-byte stores incl.).
                int emitted = 0;
                // First 1-3 literal sites are UNROLLED so each position
                // gets its own branch PC: on lit/match-alternating streams
                // (filtered photo content: one noise literal then a row
                // match, per pixel) a single looped branch site is
                // near-unpredictable while distinct sites are near-static.
#define INFL_LIT_SITE()                                                  \
    do {                                                                 \
        if (kind <= INFL_K_LIT3 && bc >= (int32_t)INFL_NBITS(e)) {       \
            uint32_t nb = INFL_NBITS(e);                                 \
            bb >>= nb;                                                   \
            bc -= (int32_t)nb;                                           \
            uint32_t p = INFL_PAYLOAD(e);                                \
            memcpy(op, &p, 4); /* one 32-bit store, margin-covered */    \
            op += kind + 1;                                              \
            ++emitted;                                                   \
            e = lltab[bb & ((1u << INFL_LL_ROOT) - 1u)];                 \
            if (INFL_KIND(e) == INFL_K_SUB)                              \
                e = lltab[INFL_PAYLOAD(e) +                              \
                          ((bb >> INFL_LL_ROOT) &                        \
                           ((1u << INFL_NBITS(e)) - 1u))];               \
            kind = INFL_KIND(e);                                         \
        }                                                                \
    } while (0)
                INFL_LIT_SITE();
                INFL_LIT_SITE();
                INFL_LIT_SITE();
#undef INFL_LIT_SITE
                int lit_budget = 5;
                while (kind <= INFL_K_LIT3 && bc >= (int32_t)INFL_NBITS(e) &&
                       lit_budget--) {
                    uint32_t nb = INFL_NBITS(e);
                    bb >>= nb;
                    bc -= (int32_t)nb;
                    uint32_t p = INFL_PAYLOAD(e);
                    memcpy(op, &p, 4);  // one 32-bit store, margin-covered
                    op += kind + 1;
                    ++emitted;
                    e = lltab[bb & ((1u << INFL_LL_ROOT) - 1u)];
                    if (INFL_KIND(e) == INFL_K_SUB)
                        e = lltab[INFL_PAYLOAD(e) +
                                  ((bb >> INFL_LL_ROOT) &
                                   ((1u << INFL_NBITS(e)) - 1u))];
                    kind = INFL_KIND(e);
                }
                if (kind <= INFL_K_LIT3) continue;  // budget/bits: refill
                if (INFL_UNLIKELY(kind != INFL_K_LEN)) {
                    if (emitted) continue;  // re-enter with fresh bits first
                    break;  // EOB/BAD at full bits: general loop decides
                }
                // A whole match needs at most NBITS(e) (len code+extra,
                // already loaded) + 28 (worst-case dist code+extra); with a
                // full reservoir it decodes refill-free. The exact bound
                // matters: a flat "bc < 48" sat on a knife edge after one
                // literal (bc ~ 47..56) and mispredicted constantly, while
                // ltot+28 (~36-41) is essentially always satisfied there.
                if (INFL_UNLIKELY(bc < (int32_t)INFL_NBITS(e) + 28)) continue;
                {
                    // NBITS = total consume (code + extra): ONE shift on
                    // the serial bb chain per symbol; base/extra come off
                    // a saved copy in parallel with the next table load.
                    uint64_t lsaved = bb;
                    uint32_t ltot = INFL_NBITS(e);
                    bb >>= ltot;
                    bc -= (int32_t)ltot;
                    uint32_t de = dtab[bb & ((1u << INFL_D_ROOT) - 1u)];
                    if (INFL_KIND(de) == INFL_K_SUB)
                        de = dtab[INFL_PAYLOAD(de) +
                                  ((bb >> INFL_D_ROOT) &
                                   ((1u << INFL_NBITS(de)) - 1u))];
                    if (INFL_UNLIKELY(INFL_KIND(de) == INFL_K_BAD)) FAIL(-8);  // 15 live bits
                    uint32_t lp = INFL_PAYLOAD(e);
                    uint32_t lcl = lp >> 16;
                    int32_t length =
                        (int32_t)(lp & 0xFFFFu) +
                        (int32_t)((lsaved >> lcl) &
                                  ((1ull << (ltot - lcl)) - 1ull));
                    uint64_t dsaved = bb;
                    uint32_t dtot = INFL_NBITS(de);
                    bb >>= dtot;
                    bc -= (int32_t)dtot;
                    uint32_t dp = INFL_PAYLOAD(de);
                    uint32_t dcl = dp >> 16;
                    int32_t dist =
                        (int32_t)(dp & 0xFFFFu) +
                        (int32_t)((dsaved >> dcl) &
                                  ((1ull << (dtot - dcl)) - 1ull));
                    // Preload the next symbol's entry while the copy runs:
                    // the post-match bit state is already final, and a later
                    // refill only adds high bits, so a root-resolved entry
                    // whose code length fits the live bits stays valid.
                    e_pre = lltab[bb & ((1u << INFL_LL_ROOT) - 1u)];
                    if (INFL_KIND(e_pre) == INFL_K_SUB)
                        e_pre = lltab[INFL_PAYLOAD(e_pre) +
                                      ((bb >> INFL_LL_ROOT) &
                                       ((1u << INFL_NBITS(e_pre)) - 1u))];
                    have_pre = (int32_t)INFL_NBITS(e_pre) <= bc &&
                               INFL_KIND(e_pre) != INFL_K_BAD;
                    int64_t produced = op - out;
                    if (INFL_UNLIKELY((uint64_t)dist > prior_out + (uint64_t)produced))
                        FAIL(-9);
                    if (INFL_LIKELY(dist <= produced)) {
                        const uint8_t* sp = op - dist;
                        if (INFL_LIKELY(dist >= 8)) {
                            // Two unconditional 8-byte stores cover the
                            // typical 3-16 byte match (the 300-byte margin
                            // absorbs the overshoot); step-8 chunks stay
                            // safe for any overlap with dist >= 8, and the
                            // long-match tail steps 16 bytes when the
                            // offset allows.
                            memcpy(op, sp, 8);
                            memcpy(op + 8, sp + 8, 8);
                            if (INFL_UNLIKELY(length > 16)) {
                                int32_t k = 16;
                                if (dist >= 16)
                                    for (; k + 16 <= length; k += 16)
                                        memcpy(op + k, sp + k, 16);
                                for (; k + 8 <= length; k += 8)
                                    memcpy(op + k, sp + k, 8);
                                for (; k < length; ++k) op[k] = sp[k];
                            }
                        } else {
                            for (int32_t k = 0; k < length; ++k) op[k] = sp[k];
                        }
                        op += length;
                    } else {
                        for (int32_t k = 0; k < length; ++k) {
                            int64_t pk = produced + k;
                            if (dist <= pk) {
                                op[k] = *(op + k - dist);
                            } else {
                                int32_t widx =
                                    st->window_len - (int32_t)(dist - pk);
                                if (widx < 0) FAIL(-10);
                                op[k] = st->window[widx];
                            }
                        }
                        op += length;
                    }
                }
            }
                INFL_FAST_SYNC();
#undef INFL_FAST_SYNC
            }
            for (;;) {
                // Worst case per iteration: 15+5+15+13 = 48 bits.
                if (st->bitcount < 48) {
                    infl_refill(st, in, in_len);
                    if (st->bitcount < 48 && st->in_pos >= in_len) {
                        // Tail mode: decode carefully bit-by-bit below.
                        if (st->bitcount <= 0) goto suspend;
                    }
                }
                uint32_t e = infl_lookup(st->litlen, st->bitbuf, INFL_LL_ROOT);
                uint32_t nb = INFL_NBITS(e);
                uint32_t kind = INFL_KIND(e);
                // A lookup is only trustworthy when the entry's code length
                // fits the live bits (prefix-code property); BAD entries
                // need all 15 index bits live to be conclusive.
                if ((int32_t)nb > st->bitcount ||
                    (kind == INFL_K_BAD && st->bitcount < 15)) {
                    infl_refill(st, in, in_len);
                    e = infl_lookup(st->litlen, st->bitbuf, INFL_LL_ROOT);
                    nb = INFL_NBITS(e);
                    kind = INFL_KIND(e);
                    if ((int32_t)nb > st->bitcount ||
                        (kind == INFL_K_BAD && st->bitcount < 15))
                        goto suspend;  // need more input
                }
                if (kind <= INFL_K_LIT3) {
                    if (op >= oend) goto suspend;
                    infl_take(st, (int)nb);
                    uint32_t p = INFL_PAYLOAD(e);
                    int cnt = (int)kind + 1;
                    for (int i = 0; i < cnt; ++i) {
                        uint8_t b = (uint8_t)(p >> (8 * i));
                        // A packed entry can carry more literals than the
                        // output has room for; park the overflow (drained
                        // first on the next call).
                        if (op < oend) *op++ = b;
                        else st->pend_lit[st->pend_lit_count++] = b;
                    }
                    if (st->pend_lit_count) goto suspend;
                    continue;
                }
                if (kind == INFL_K_EOB) {
                    infl_take(st, (int)nb);
                    st->state = st->final_block ? 4 : 1;
                    break;
                }
                if (kind == INFL_K_BAD) FAIL(-7);
                // Match. nb is the TOTAL consume (code + extra; see
                // infl_build_table) and the nb > bitcount gate above
                // already guaranteed the whole length field is live.
                {
                    uint64_t lsaved = st->bitbuf;
                    uint32_t lp = INFL_PAYLOAD(e);
                    uint32_t lcl = lp >> 16;
                    infl_take(st, (int)nb);
                    int32_t length =
                        (int32_t)(lp & 0xFFFFu) +
                        (int32_t)((lsaved >> lcl) &
                                  ((1ull << (nb - lcl)) - 1ull));
                uint32_t de = infl_lookup(st->dist, st->bitbuf, INFL_D_ROOT);
                uint32_t dnb = INFL_NBITS(de);
                if (st->bitcount < (int32_t)dnb ||
                    (INFL_KIND(de) == INFL_K_BAD && st->bitcount < 15)) {
                    infl_refill(st, in, in_len);
                    de = infl_lookup(st->dist, st->bitbuf, INFL_D_ROOT);
                    dnb = INFL_NBITS(de);
                    if (st->bitcount < (int32_t)dnb ||
                        (INFL_KIND(de) == INFL_K_BAD && st->bitcount < 15)) {
                        // The length code is consumed but the distance bits
                        // haven't arrived yet: park the match (negative =
                        // distance still undecoded) and wait for input.
                        st->pending_len = -length;
                        goto suspend;
                    }
                }
                if (INFL_KIND(de) == INFL_K_BAD) FAIL(-8);
                uint64_t dsaved = st->bitbuf;
                uint32_t dp = INFL_PAYLOAD(de);
                uint32_t dcl = dp >> 16;
                infl_take(st, (int)dnb);
                int32_t dist =
                    (int32_t)(dp & 0xFFFFu) +
                    (int32_t)((dsaved >> dcl) &
                              ((1ull << (dnb - dcl)) - 1ull));
                if ((uint64_t)dist > st->total_out + (uint64_t)(op - out))
                    FAIL(-9);
                {
                    int64_t produced = op - out;
                    int64_t space = oend - op;
                    int32_t n = length;
                    if (n > space) n = (int32_t)space;
                    if (dist <= produced) {
                        // Copy within this output buffer.
                        uint8_t* src = op - dist;
                        if (dist >= 8) {
                            int32_t k = 0;
                            for (; k + 8 <= n; k += 8) memcpy(op + k, src + k, 8);
                            for (; k < n; ++k) op[k] = src[k];
                        } else {
                            for (int32_t k = 0; k < n; ++k) op[k] = src[k];
                        }
                        op += n;
                    } else {
                        // Source starts in the window.
                        int32_t k = 0;
                        for (; k < n; ++k) {
                            int64_t produced_k = produced + k;
                            if (dist <= produced_k) {
                                op[k] = *(op + k - dist);
                            } else {
                                int32_t widx =
                                    st->window_len - (int32_t)(dist - produced_k);
                                if (widx < 0) FAIL(-10);
                                op[k] = st->window[widx];
                            }
                        }
                        op += n;
                    }
                    if (n < length) {
                        st->pending_len = length - n;
                        st->pending_dist = dist;
                        goto suspend;
                    }
                }
                }
            }
            continue;
        } else if (st->state == 4) {  // adler32 trailer after byte align
            infl_take(st, st->bitcount & 7);
            if (!infl_have(st, in, in_len, 32)) break;
            {
                // Trailer is big-endian; the LSB-first reader yields its
                // bytes in stream order from the low end. Stored for the
                // caller's strict mode — the decoder itself stays
                // verification-free (chunk CRC-32 covers default mode).
                uint32_t v = infl_take(st, 32);
                st->stream_adler = ((v & 0xFFu) << 24) |
                                   ((v & 0xFF00u) << 8) |
                                   ((v >> 8) & 0xFF00u) | (v >> 24);
            }
            st->state = 5;
        } else {  // done
            break;
        }
    }
suspend:
    // Resume for a length-decoded-but-distance-pending match.
    if (st->pending_len < 0) {
        int rc = infl_resolve_pending_dist(st, in, in_len, out, &op, oend);
        if (rc < 0) return rc;
    }
    {
        // Roll the 32KB window forward over this call's output.
        int64_t produced = op - out;
        if (produced >= 32768) {
            memcpy(st->window, op - 32768, 32768);
            st->window_len = 32768;
        } else if (produced > 0) {
            int32_t keep = 32768 - (int32_t)produced;
            if (st->window_len < keep) keep = st->window_len;
            if (keep > 0)
                memmove(st->window, st->window + st->window_len - keep,
                        (size_t)keep);
            memcpy(st->window + keep, out, (size_t)produced);
            st->window_len = keep + (int32_t)produced;
        }
        st->total_out += produced;
        return produced;
    }
#undef FAIL
}

int64_t owned_inflate_state_size(void) { return (int64_t)sizeof(InflState); }
int32_t owned_inflate_state(const InflState* st) { return st->state; }
uint32_t owned_inflate_stream_adler(const InflState* st) {
    return st->stream_adler;
}
int32_t owned_inflate_error(const InflState* st) { return st->error; }
int64_t owned_inflate_in_pos(const InflState* st) { return st->in_pos; }

void owned_inflate_rebase(InflState* st) {
    // Caller compacted its input buffer by dropping st->in_pos consumed
    // bytes (bits already in bitbuf are unaffected).
    st->in_pos = 0;
}

}  // extern "C" (inflate)

extern "C" {

// ---------------------------------------------------------------------------
// Owned streaming deflate (RFC 1950/1951) — replaces runtime zlib on the
// encode hot path (SURVEY §2 native items: runtime zlib / pako). The PNG
// writer's Z_SYNC_FLUSH batching (reference streaming-deflate.ts:41-242)
// maps to one stateless call per batch: the caller passes the previous
// 32KB window contiguously before the new data, each batch emits complete
// deflate blocks plus a sync marker (or the final block), and the zlib
// header/Adler-32 trailer live in the Python wrapper.
//
// Design: hash4 chain matcher with a hash3 head for length-3 matches
// (zlib parity: len-3 only within 4096), one-step lazy evaluation,
// 8-byte XOR/ctz match extension, symbols buffered per <=256KB block,
// then exact-cost selection between dynamic, static and stored encodings.
// ---------------------------------------------------------------------------

#define DEFL_H4_BITS 15
#define DEFL_H3_BITS 14
#define DEFL_WIN 32768
#define DEFL_BLOCK_RAW (256 * 1024)

typedef struct DeflScratch {
    int32_t head4[1 << DEFL_H4_BITS];
    int32_t head3[1 << DEFL_H3_BITS];
    int32_t prev[DEFL_WIN];
    uint32_t syms[DEFL_BLOCK_RAW + 1];  // lit: v<256; match: 1<<31|len3<<16|dist
} DeflScratch;

int64_t owned_deflate_scratch_size(void) { return (int64_t)sizeof(DeflScratch); }

// --- length/distance symbol tables (built once) ---------------------------

static uint8_t defl_len_sym[256];    // (len-3) -> litlen sym - 257
static uint8_t defl_len_extra[256];  // extra bit count
static uint16_t defl_len_base[29];
static uint8_t defl_dist_sym_small[512];  // dist-1 (<512) -> dist sym
static uint8_t defl_dist_sym_big[256];    // (dist-1)>>7 -> dist sym (dist>512)
static int defl_tables_init = 0;

static void defl_init_tables(void) {
    if (defl_tables_init) return;
    for (int s = 0; s < 29; ++s) defl_len_base[s] = kLenBase[s];
    for (int l = 0; l < 256; ++l) {  // l = len - 3, len in 3..258
        int len = l + 3;
        int s = 28;
        while (s > 0 && kLenBase[s] > len) --s;
        if (s < 28 && kLenBase[s + 1] <= len) ++s;
        // length 258 must use sym 28 (extra 0), not 227+31
        if (len == 258) s = 28;
        defl_len_sym[l] = (uint8_t)s;
        defl_len_extra[l] = kLenExtra[s];
    }
    for (int d = 1; d <= 512; ++d) {
        int s = 29;
        while (s > 0 && kDistBase[s] > d) --s;
        if (d <= 512 && d >= 1) defl_dist_sym_small[d - 1] = (uint8_t)s;
    }
    for (int i = 0; i < 256; ++i) {
        int d = (i << 7) + 1;  // representative dist with (dist-1)>>7 == i
        if (d < 513) d = 513;
        int s = 29;
        while (s > 0 && kDistBase[s] > d) --s;
        defl_dist_sym_big[i] = (uint8_t)s;
    }
    defl_tables_init = 1;
}

static inline int defl_dist_code(int dist) {
    return dist <= 512 ? defl_dist_sym_small[dist - 1]
                       : defl_dist_sym_big[(dist - 1) >> 7];
}

static inline uint32_t defl_load32(const uint8_t* p) {
    uint32_t v;
    memcpy(&v, p, 4);
    return v;
}
static inline uint64_t defl_load64(const uint8_t* p) {
    uint64_t v;
    memcpy(&v, p, 8);
    return v;
}
static inline uint32_t defl_h4(const uint8_t* p) {
    return (defl_load32(p) * 0x9E3779B1u) >> (32 - DEFL_H4_BITS);
}
static inline uint32_t defl_h3(const uint8_t* p) {
    return ((defl_load32(p) & 0xFFFFFFu) * 0x9E3779B1u) >> (32 - DEFL_H3_BITS);
}

// --- bit writer (LSB-first per RFC 1951) ----------------------------------

typedef struct {
    uint64_t bits;
    int32_t count;
    uint8_t* out;
} DeflBits;

static inline void defl_putbits(DeflBits* b, uint32_t v, int n) {
    b->bits |= (uint64_t)v << b->count;
    b->count += n;
    if (b->count >= 48) {
        memcpy(b->out, &b->bits, 8);  // little-endian host
        b->out += b->count >> 3;
        b->bits >>= (b->count & ~7);
        b->count &= 7;
    }
}

static inline void defl_putbits_wide(DeflBits* b, uint64_t v, int n) {
    // Up to 48 bits in one call (a whole match: len code+extra, dist
    // code+extra). Pre-flush whole bytes so count <= 7 before the shift
    // (7 + 48 = 55 fits the accumulator); the unconditional 8-byte store
    // is covered by the same slack margin as defl_putbits' flush.
    memcpy(b->out, &b->bits, 8);
    b->out += b->count >> 3;
    b->bits >>= (b->count & ~7);
    b->count &= 7;
    b->bits |= v << b->count;
    b->count += n;
}

static inline void defl_align(DeflBits* b) {
    while (b->count > 0) {
        *b->out++ = (uint8_t)b->bits;
        b->bits >>= 8;
        b->count -= 8;
    }
    b->count = 0;
    b->bits = 0;
}

static inline uint32_t defl_revcode(uint32_t c, int len) {
    uint32_t r = 0;
    for (int i = 0; i < len; ++i) r |= ((c >> i) & 1u) << (len - 1 - i);
    return r;
}

// --- limited-length Huffman construction ----------------------------------

// freqs[n] -> lens[n] with max length `limit`; returns 0. Zero-freq symbols
// get length 0. Classic build + zlib-style overflow adjustment, lengths
// reassigned to symbols in frequency order.
static void defl_build_lengths(const uint32_t* freq, int n, int limit,
                               uint8_t* lens) {
    int order[320];
    int cnt = 0;
    for (int i = 0; i < n; ++i) {
        lens[i] = 0;
        if (freq[i]) order[cnt++] = i;
    }
    if (cnt == 0) return;
    if (cnt == 1) { lens[order[0]] = 1; return; }
    // insertion sort by freq ascending (n <= 286, blocks are large: fine)
    for (int i = 1; i < cnt; ++i) {
        int o = order[i];
        int j = i - 1;
        while (j >= 0 && freq[order[j]] > freq[o]) {
            order[j + 1] = order[j];
            --j;
        }
        order[j + 1] = o;
    }
    // Moffat-Katajainen in-place: A holds freqs, becomes parent links, then
    // depths.
    uint64_t A[320];
    for (int i = 0; i < cnt; ++i) A[i] = freq[order[i]];
    int leaf = 0, root = 0;
    for (int next = 0; next < cnt - 1; ++next) {
        // first child
        if (leaf >= cnt || (root < next && A[root] < A[leaf])) {
            A[next] = A[root];
            A[root++] = (uint64_t)next;
        } else {
            A[next] = A[leaf++];
        }
        // second child
        if (leaf >= cnt || (root < next && A[root] < A[leaf])) {
            A[next] += A[root];
            A[root++] = (uint64_t)next;
        } else {
            A[next] += A[leaf++];
        }
    }
    // depths
    A[cnt - 2] = 0;
    for (int i = cnt - 3; i >= 0; --i) A[i] = A[(int)A[i]] + 1;
    int avail = 1, used = 0, dep = 0, next = cnt - 2, nleaves = 0;
    int bl_count[64];
    memset(bl_count, 0, sizeof bl_count);
    while (avail > 0) {
        while (next >= 0 && (int)A[next] == dep) {
            ++used;
            --next;
        }
        int leaves_here = avail - used;
        if (dep > 63) break;
        bl_count[dep] = leaves_here;
        nleaves += leaves_here;
        avail = 2 * used;
        used = 0;
        ++dep;
    }
    // Overflow adjustment onto `limit` (zlib trees.c gen_bitlen). The
    // iteration count must equal the Kraft deficit, and zlib gets that by
    // counting EVERY clamped node — internal nodes too, not just leaves
    // (each zlib pass moves one leaf bits->bits+1 and re-homes one
    // limit-depth leaf beside it, recovering exactly one 2^-limit Kraft
    // unit; #nodes-beyond-limit == 2 * deficit). Counting only the leaf
    // histogram under-iterates on deep trees and emits an over-subscribed
    // — i.e. undecodable — code (hit in production by noise-tile PNGs).
    int leaf_over = 0;
    for (int d = limit + 1; d < 64; ++d) {
        leaf_over += bl_count[d];
        bl_count[d] = 0;
    }
    int overflow = leaf_over;
    for (int i = 0; i <= cnt - 2; ++i)
        if ((int)A[i] > limit) ++overflow;  // internal nodes beyond limit
    bl_count[limit] += leaf_over;
    while (overflow > 0) {
        int bits = limit - 1;
        while (bits > 0 && bl_count[bits] == 0) --bits;
        if (bits == 0) break;
        bl_count[bits]--;
        bl_count[bits + 1] += 2;
        bl_count[limit]--;
        overflow -= 2;
    }
    // Exact-Kraft verification: an invalid code corrupts the stream
    // silently, so verify and fall back to a flat complete code (k most
    // frequent symbols at l-1, the rest at l, with k = 2^l - cnt) rather
    // than ever emitting an over- or under-subscribed table.
    {
        long long left = 1LL << limit;
        for (int d = 1; d <= limit; ++d)
            left -= (long long)bl_count[d] << (limit - d);
        if (left != 0) {
            int l = 1;
            while ((1 << l) < cnt) ++l;
            int k = (1 << l) - cnt;
            memset(bl_count, 0, sizeof bl_count);
            bl_count[l - 1] = k;
            bl_count[l] = cnt - k;
        }
    }
    // reassign: most frequent symbols get the shortest lengths
    int idx = cnt - 1;  // order[] ascending freq -> walk from the top
    for (int d = 1; d <= limit; ++d) {
        for (int k = 0; k < bl_count[d]; ++k) {
            lens[order[idx--]] = (uint8_t)d;
        }
    }
}

// canonical codes (already bit-reversed for LSB-first emission)
static void defl_build_codes(const uint8_t* lens, int n, uint16_t* codes) {
    int bl_count[16];
    memset(bl_count, 0, sizeof bl_count);
    for (int i = 0; i < n; ++i) bl_count[lens[i]]++;
    bl_count[0] = 0;
    uint32_t next_code[16];
    uint32_t code = 0;
    for (int b = 1; b <= 15; ++b) {
        code = (code + bl_count[b - 1]) << 1;
        next_code[b] = code;
    }
    for (int i = 0; i < n; ++i) {
        codes[i] = lens[i]
                       ? (uint16_t)defl_revcode(next_code[lens[i]]++, lens[i])
                       : 0;
    }
}

// --- dynamic header: code-lengths-code RLE --------------------------------

static const uint8_t kClOrderEnc[19] = {
    16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};

typedef struct {
    uint8_t sym;
    uint8_t extra_bits;
    uint8_t extra_val;
} ClItem;

// RLE-encode the hlit+hdist length sequence into cl items; fills cl_freq.
static int defl_cl_rle(const uint8_t* lens, int n, ClItem* items,
                       uint32_t* cl_freq) {
    int m = 0;
    int i = 0;
    while (i < n) {
        uint8_t v = lens[i];
        int run = 1;
        while (i + run < n && lens[i + run] == v) ++run;
        if (v == 0) {
            while (run >= 3) {
                int take = run > 138 ? 138 : run;
                if (take < 11) {
                    if (take > 10) take = 10;
                    items[m].sym = 17;
                    items[m].extra_bits = 3;
                    items[m].extra_val = (uint8_t)(take - 3);
                } else {
                    items[m].sym = 18;
                    items[m].extra_bits = 7;
                    items[m].extra_val = (uint8_t)(take - 11);
                }
                cl_freq[items[m].sym]++;
                ++m;
                run -= take;
            }
            while (run-- > 0) {
                items[m].sym = 0;
                items[m].extra_bits = 0;
                items[m].extra_val = 0;
                cl_freq[0]++;
                ++m;
            }
        } else {
            items[m].sym = v;
            items[m].extra_bits = 0;
            items[m].extra_val = 0;
            cl_freq[v]++;
            ++m;
            --run;
            while (run >= 3) {
                int take = run > 6 ? 6 : run;
                items[m].sym = 16;
                items[m].extra_bits = 2;
                items[m].extra_val = (uint8_t)(take - 3);
                cl_freq[16]++;
                ++m;
                run -= take;
            }
            while (run-- > 0) {
                items[m].sym = v;
                items[m].extra_bits = 0;
                items[m].extra_val = 0;
                cl_freq[v]++;
                ++m;
            }
        }
        i += 0;
        // advance i over the run we consumed
        {
            // recompute: we consumed the whole run of equal values
            int run2 = 1;
            while (i + run2 < n && lens[i + run2] == v) ++run2;
            i += run2;
        }
    }
    return m;
}

// --- static (fixed) code tables -------------------------------------------

static uint8_t defl_static_ll_lens[288];
static uint16_t defl_static_ll_codes[288];
static uint8_t defl_static_d_lens[30];
static uint16_t defl_static_d_codes[30];
static int defl_static_init = 0;

static void defl_init_static(void) {
    if (defl_static_init) return;
    for (int i = 0; i < 144; ++i) defl_static_ll_lens[i] = 8;
    for (int i = 144; i < 256; ++i) defl_static_ll_lens[i] = 9;
    for (int i = 256; i < 280; ++i) defl_static_ll_lens[i] = 7;
    for (int i = 280; i < 288; ++i) defl_static_ll_lens[i] = 8;
    defl_build_codes(defl_static_ll_lens, 288, defl_static_ll_codes);
    for (int i = 0; i < 30; ++i) defl_static_d_lens[i] = 5;
    defl_build_codes(defl_static_d_lens, 30, defl_static_d_codes);
    defl_static_init = 1;
}

// --- match finding --------------------------------------------------------

typedef struct {
    int max_chain;
    int lazy;      // one-step lazy evaluation enabled
    int max_lazy;  // only defer when the current match is shorter than this
    int good;      // quarter the chain budget when current match >= good
    int nice;      // stop searching at this length
    int use_h3;    // probe/maintain the len-3 side head (ratio profiles)
    int lazy_shift;  // chain budget >>= this on every lazy (second) search
} DeflProfile;

// Level-6 profile knobs, overridable at compile time for the interleaved
// parameter sweep (scripts/sweep_deflate_profile.py builds variant .so's
// with -D overrides). Defaults ARE the production profile — bytes change
// only when a sweep result is promoted here.
#ifndef DEFL_L6_CHAIN
#define DEFL_L6_CHAIN 8
#endif
#ifndef DEFL_L6_MAXLAZY
#define DEFL_L6_MAXLAZY 24
#endif
#ifndef DEFL_L6_NICE
#define DEFL_L6_NICE 96
#endif
#ifndef DEFL_L6_LAZYSHIFT
#define DEFL_L6_LAZYSHIFT 2
#endif

static DeflProfile defl_profile(int level) {
    DeflProfile p;
    // Tuned on filtered-PNG payloads: chain depth beyond ~16 costs speed
    // almost linearly while the ratio stays flat (big dynamic blocks do
    // the heavy lifting); even the fast profile beats zlib-6's ratio.
    // use_h3: len-3 matches are a RATIO-profile feature only — on
    // filtered-PNG payloads they cost bits (far 3-byte matches encode
    // longer than 3 literals under the big dynamic trees: dropping them
    // measured -0.2% size AND +8% speed; noise +72% speed) and the h3
    // hash+store per position is a third of insert cost. Text-like
    // content loses ~3.7% size without them, so level >= 7 keeps h3.
    // lazy_shift: the one-step-lazy SECOND search (at i+1, with a match
    // in hand) rarely changes the parse, so speed profiles cut its chain
    // budget to a quarter unconditionally (round-4 interleaved A/B:
    // lazy-quarter alone +41-45% speed at +1.15% size; with max_chain
    // 24->8 cumulative ~2.6x at a size still 2.6% under zlib-6 on bench
    // content, text/noise sizes unchanged). Ratio profiles (level >= 7)
    // keep the zlib rule instead: quarter only when the match in hand is
    // already >= good.
    if (level <= 3) { p.max_chain = 4;   p.lazy = 1; p.max_lazy = 16;  p.good = 4;  p.nice = 32;  p.use_h3 = 0; p.lazy_shift = 2; }
    else if (level <= 6) { p.max_chain = DEFL_L6_CHAIN; p.lazy = 1; p.max_lazy = DEFL_L6_MAXLAZY; p.good = 8; p.nice = DEFL_L6_NICE; p.use_h3 = 0; p.lazy_shift = DEFL_L6_LAZYSHIFT; }
    else { p.max_chain = 128; p.lazy = 1; p.max_lazy = 258; p.good = 32; p.nice = 258; p.use_h3 = 1; p.lazy_shift = 0; }
    return p;
}

static inline int defl_extend(const uint8_t* a, const uint8_t* b, int max_len) {
    int n = 0;
    while (n + 8 <= max_len) {
        uint64_t x = defl_load64(a + n) ^ defl_load64(b + n);
        if (x) return n + (__builtin_ctzll(x) >> 3);
        n += 8;
    }
    while (n < max_len && a[n] == b[n]) ++n;
    return n;
}

// Best match at pos i (absolute index into buf); buf[i..end) is available.
// Returns length (0 if none acceptable), sets *dist.
static int defl_find_match(const DeflScratch* s, const uint8_t* buf,
                           int64_t i, int64_t end, const DeflProfile* pf,
                           int prev_len, int* dist_out,
                           uint32_t h4, uint32_t h3) {
    int max_len = (int)(end - i);
    if (max_len > 258) max_len = 258;
    if (max_len < 3) return 0;
    int best_len = prev_len >= 2 ? prev_len : 2;  // must beat this
    int best_dist = 0;
    int64_t min_pos = i - DEFL_WIN;
    // length-3 candidate from the hash3 head (zlib: len-3 only if close)
    if (pf->use_h3 && best_len < 3) {
        int32_t c3 = s->head3[h3];
        if (c3 >= 0 && (int64_t)c3 > min_pos && i - c3 <= 4096) {
            if (buf[c3] == buf[i] && buf[c3 + 1] == buf[i + 1] &&
                buf[c3 + 2] == buf[i + 2]) {
                int l = defl_extend(buf + c3, buf + i, max_len);
                if (l >= 3) {
                    best_len = l;
                    best_dist = (int)(i - c3);
                }
            }
        }
    }
    int chain = pf->max_chain;
    if (prev_len > 0) {
        if (pf->lazy_shift) chain >>= pf->lazy_shift;
        else if (prev_len >= pf->good) chain >>= 2;
    }
    if (max_len >= 4 && best_len < pf->nice) {
        int32_t cand = s->head4[h4];
        while (cand >= 0 && (int64_t)cand > min_pos && chain-- > 0) {
            // Quick reject: 4 bytes ENDING at the would-be-deciding
            // byte (a candidate only helps if its first best_len+1 bytes
            // all match, which includes this window) plus the 4-byte
            // prefix — an 8-byte necessary condition that kills most
            // hash collisions before the extend (the byte-at-best_len
            // test alone let ~1/3 of probes through to extends).
            int bl3 = best_len - 3;
            if (bl3 < 0) bl3 = 0;
            if (best_len < max_len &&
                defl_load32(buf + cand + bl3) == defl_load32(buf + i + bl3) &&
                defl_load32(buf + cand) == defl_load32(buf + i)) {
                int l = defl_extend(buf + cand, buf + i, max_len);
                if (l > best_len) {
                    best_len = l;
                    best_dist = (int)(i - cand);
                    if (l >= pf->nice || l >= max_len) break;
                }
            }
            cand = s->prev[cand & (DEFL_WIN - 1)];
        }
    }
    if (best_dist == 0) return 0;
    *dist_out = best_dist;
    return best_len;
}

static inline void defl_insert_h(DeflScratch* s, int64_t i, uint32_t h4,
                                 uint32_t h3, int use_h3) {
    s->prev[i & (DEFL_WIN - 1)] = s->head4[h4];
    s->head4[h4] = (int32_t)i;
    if (use_h3) s->head3[h3] = (int32_t)i;
}

static inline void defl_insert(DeflScratch* s, const uint8_t* buf, int64_t i) {
    defl_insert_h(s, i, defl_h4(buf + i), defl_h3(buf + i), 1);
}

// --- block emission -------------------------------------------------------

// Emit one complete deflate block for syms[0..n_syms) covering raw bytes
// buf[raw_start..raw_end). Chooses dynamic/static/stored by exact bit cost.
static int defl_emit_block(DeflBits* bw, const uint8_t* buf, int64_t raw_start,
                           int64_t raw_end, const uint32_t* syms, int n_syms,
                           const uint32_t* freq_ll, const uint32_t* freq_d,
                           int64_t extra_bits_total, int is_final,
                           const uint8_t* out_cap_end) {
    defl_init_static();
    uint8_t ll_lens[288], d_lens[30];
    uint16_t ll_codes[288], d_codes[30];
    defl_build_lengths(freq_ll, 286, 15, ll_lens);
    memset(ll_lens + 286, 0, 2);
    defl_build_lengths(freq_d, 30, 15, d_lens);
    defl_build_codes(ll_lens, 288, ll_codes);
    defl_build_codes(d_lens, 30, d_codes);

    int hlit = 286;
    while (hlit > 257 && ll_lens[hlit - 1] == 0) --hlit;
    int hdist = 30;
    while (hdist > 1 && d_lens[hdist - 1] == 0) --hdist;

    uint8_t all_lens[286 + 30];
    memcpy(all_lens, ll_lens, (size_t)hlit);
    memcpy(all_lens + hlit, d_lens, (size_t)hdist);
    ClItem items[286 + 30];
    uint32_t cl_freq[19];
    memset(cl_freq, 0, sizeof cl_freq);
    int n_items = defl_cl_rle(all_lens, hlit + hdist, items, cl_freq);
    uint8_t cl_lens[19];
    uint16_t cl_codes[19];
    defl_build_lengths(cl_freq, 19, 7, cl_lens);
    defl_build_codes(cl_lens, 19, cl_codes);
    int hclen = 19;
    while (hclen > 4 && cl_lens[kClOrderEnc[hclen - 1]] == 0) --hclen;

    // exact bit costs
    int64_t sym_bits_dyn = 0, sym_bits_static = 0;
    for (int v = 0; v < 286; ++v) {
        if (!freq_ll[v]) continue;
        sym_bits_dyn += (int64_t)freq_ll[v] * ll_lens[v];
        sym_bits_static += (int64_t)freq_ll[v] * defl_static_ll_lens[v];
    }
    for (int v = 0; v < 30; ++v) {
        if (!freq_d[v]) continue;
        sym_bits_dyn += (int64_t)freq_d[v] * d_lens[v];
        sym_bits_static += (int64_t)freq_d[v] * defl_static_d_lens[v];
    }
    int64_t hdr_bits = 5 + 5 + 4 + 3 * hclen;
    for (int k = 0; k < n_items; ++k)
        hdr_bits += cl_lens[items[k].sym] + items[k].extra_bits;
    int64_t dyn_bits = 3 + hdr_bits + sym_bits_dyn + extra_bits_total;
    int64_t static_bits = 3 + sym_bits_static + extra_bits_total;
    int64_t raw_len = raw_end - raw_start;
    // stored: 3-bit header + align + per-64KB-part 32-bit LEN/NLEN + bytes
    int64_t n_parts = raw_len == 0 ? 1 : (raw_len + 65534) / 65535;
    int64_t stored_bits = 3 + 7 + n_parts * 32 + 8 * raw_len +
                          (n_parts - 1) * (3 + 7);

    int64_t best = dyn_bits < static_bits ? dyn_bits : static_bits;
    if (stored_bits < best) best = stored_bits;
    // capacity check (best/8 + slack)
    if (bw->out + best / 8 + 64 > out_cap_end) return -1;

    if (best == stored_bits) {
        int64_t off = raw_start;
        int64_t left = raw_len;
        do {
            int64_t part = left > 65535 ? 65535 : left;
            int final_part = is_final && part == left;
            defl_putbits(bw, final_part ? 1u : 0u, 1);
            defl_putbits(bw, 0u, 2);
            defl_align(bw);
            bw->out[0] = (uint8_t)part;
            bw->out[1] = (uint8_t)(part >> 8);
            bw->out[2] = (uint8_t)(~part & 0xFF);
            bw->out[3] = (uint8_t)((~part >> 8) & 0xFF);
            bw->out += 4;
            memcpy(bw->out, buf + off, (size_t)part);
            bw->out += part;
            off += part;
            left -= part;
        } while (left > 0);
        return 0;
    }

    const uint8_t* use_ll_lens = ll_lens;
    const uint16_t* use_ll_codes = ll_codes;
    const uint8_t* use_d_lens = d_lens;
    const uint16_t* use_d_codes = d_codes;
    defl_putbits(bw, is_final ? 1u : 0u, 1);
    if (best == static_bits) {
        defl_putbits(bw, 1u, 2);
        use_ll_lens = defl_static_ll_lens;
        use_ll_codes = defl_static_ll_codes;
        use_d_lens = defl_static_d_lens;
        use_d_codes = defl_static_d_codes;
    } else {
        defl_putbits(bw, 2u, 2);
        defl_putbits(bw, (uint32_t)(hlit - 257), 5);
        defl_putbits(bw, (uint32_t)(hdist - 1), 5);
        defl_putbits(bw, (uint32_t)(hclen - 4), 4);
        for (int k = 0; k < hclen; ++k)
            defl_putbits(bw, cl_lens[kClOrderEnc[k]], 3);
        for (int k = 0; k < n_items; ++k) {
            const ClItem* it = &items[k];
            defl_putbits(bw, cl_codes[it->sym], cl_lens[it->sym]);
            if (it->extra_bits)
                defl_putbits(bw, it->extra_val, it->extra_bits);
        }
    }
    // Pre-merge the whole length side per len3 (code + extra value +
    // total bit count depend only on len3 and this block's code table):
    // one table load + one wide putbits per match instead of four
    // dependent putbits with five table walks (emit was ~40% of the
    // level-6 stage once the matcher got cheap — round-4 profile).
    uint32_t len_emit_val[256];
    uint8_t len_emit_bits[256];
    for (int l3 = 0; l3 < 256; ++l3) {
        int ls = defl_len_sym[l3];
        int lsym = 257 + ls;
        len_emit_val[l3] =
            use_ll_codes[lsym] |
            ((uint32_t)(l3 + 3 - defl_len_base[ls]) << use_ll_lens[lsym]);
        len_emit_bits[l3] =
            (uint8_t)(use_ll_lens[lsym] + defl_len_extra[l3]);
    }
    for (int k = 0; k < n_syms; ++k) {
        uint32_t sy = syms[k];
        if (!(sy & 0x80000000u)) {
            // Literal pair: merge two adjacent literal codes (<= 30 bits)
            // into one accumulate — literals are ~half the symbol stream
            // on filtered-PNG content (+3% interleaved).
            if (k + 1 < n_syms && !(syms[k + 1] & 0x80000000u)) {
                uint32_t sy2 = syms[k + 1];
                defl_putbits_wide(
                    bw,
                    use_ll_codes[sy] |
                        ((uint64_t)use_ll_codes[sy2] << use_ll_lens[sy]),
                    use_ll_lens[sy] + use_ll_lens[sy2]);
                ++k;
                continue;
            }
            defl_putbits(bw, use_ll_codes[sy], use_ll_lens[sy]);
        } else {
            int len3 = (int)((sy >> 16) & 0xFFu);
            int dist = (int)(sy & 0xFFFFu);
            int dsym = (int)((sy >> 24) & 0x1Fu);
            int ln = len_emit_bits[len3];
            uint64_t dv = use_d_codes[dsym] |
                          ((uint64_t)(uint32_t)(dist - kDistBase[dsym])
                           << use_d_lens[dsym]);
            int dn = use_d_lens[dsym] + kDistExtra[dsym];
            defl_putbits_wide(bw, len_emit_val[len3] | (dv << ln), ln + dn);
        }
    }
    defl_putbits(bw, use_ll_codes[256], use_ll_lens[256]);  // EOB
    return 0;
}

// --- batch entry ----------------------------------------------------------

// buf[0..hist_len): window history (not emitted); buf[hist_len..total_len):
// new data to compress. Emits complete deflate blocks; if is_final, the
// last block has BFINAL set, otherwise a Z_SYNC_FLUSH empty stored block
// follows. Returns bytes written to out, or -1 if out_cap is insufficient.
// Build the lazily-initialized symbol/code tables from a single thread.
// Parallel deflate (host_threads) runs owned_deflate_batch concurrently;
// the idempotent lazy init would be a (benign but formal) data race.
void owned_deflate_warmup(void) {
    defl_init_tables();
    defl_init_static();
}

int64_t owned_deflate_batch(const uint8_t* buf, int64_t hist_len,
                            int64_t total_len, int is_final, int level,
                            uint8_t* out, int64_t out_cap, DeflScratch* s) {
    defl_init_tables();
    // Bit 4 of `level` selects the FILTERED-SCANLINE profile (the PNG
    // writer's content class: filter residuals, matches mostly one-row
    // back). Interleaved sweep on that class (sweep_deflate_profile.py,
    // round 4): chain 4 is +20% stage speed at +0.34% vs zlib-6 (the
    // generic profile sits -2.7%), while on text chain 4 costs real
    // ratio — so the generic API keeps the deeper chain and only the
    // PNG writer opts in. Levels >= 7 (ratio profiles) ignore the flag.
    int filtered = level & 0x10;
    level &= 0xF;
    DeflProfile pf = defl_profile(level);
    if (filtered && level >= 4 && level <= 6) pf.max_chain = 4;
    memset(s->head4, -1, sizeof s->head4);
    memset(s->head3, -1, sizeof s->head3);
    // prev entries are guarded by the min_pos window check; stale values
    // never dereference out of range because chain walks stop at i-32768.
    memset(s->prev, -1, sizeof s->prev);
    for (int64_t i = 0; i + 3 < hist_len; ++i) defl_insert(s, buf, i);

    DeflBits bw = {0, 0, out};
    const uint8_t* cap_end = out + out_cap;
    int64_t pos = hist_len;
    int rc = 0;
    if (total_len == hist_len) {
        // empty batch: final needs an empty terminating block
        if (is_final) {
            uint32_t f_ll[286];
            memset(f_ll, 0, sizeof f_ll);
            uint32_t f_d[30];
            memset(f_d, 0, sizeof f_d);
            f_ll[256] = 1;
            rc = defl_emit_block(&bw, buf, pos, pos, s->syms, 0, f_ll, f_d, 0,
                                 1, cap_end);
            if (rc < 0) return -1;
        }
    }
    while (pos < total_len) {
        int64_t chunk_end = pos + DEFL_BLOCK_RAW;
        if (chunk_end > total_len) chunk_end = total_len;
        int final_block = is_final && chunk_end == total_len;
        uint32_t freq_ll[286];
        memset(freq_ll, 0, sizeof freq_ll);
        uint32_t freq_d[30];
        memset(freq_d, 0, sizeof freq_d);
        freq_ll[256] = 1;  // EOB
        int64_t extra_bits = 0;
        int n_syms = 0;
        int64_t raw_start = pos;
        int64_t i = pos;
        // one-step lazy parse
        int have_prev = 0;
        int prev_match_len = 0, prev_match_dist = 0;
        int miss_run = 0;  // consecutive literal emissions (no match found)
        while (i < chunk_end) {
            int dist = 0;
            int len = 0;
            // One hash computation per position, shared by find+insert (the
            // head-table loads are the dominant random accesses on
            // low-match content). Loads past total_len are safe: the caller
            // guarantees 8 readable slack bytes.
            uint32_t h4 = defl_h4(buf + i);
            uint32_t h3 = pf.use_h3 ? defl_h3(buf + i) : 0;
            if (chunk_end - i >= 3)
                len = defl_find_match(s, buf, i, chunk_end, &pf,
                                      have_prev ? prev_match_len : 0, &dist,
                                      h4, h3);
            if (have_prev && len <= prev_match_len) {
                // previous match wins: emit it (i is one past its start)
                miss_run = 0;
                int l3 = prev_match_len - 3;
                int dsym = defl_dist_code(prev_match_dist);
                s->syms[n_syms++] = 0x80000000u | ((uint32_t)dsym << 24) |
                                    ((uint32_t)l3 << 16) |
                                    (uint32_t)prev_match_dist;
                freq_ll[257 + defl_len_sym[l3]]++;
                freq_d[dsym]++;
                extra_bits += defl_len_extra[l3] + kDistExtra[dsym];
                // insert remaining positions of the match (h4 chain
                // only: a len-3 head3 candidate STARTING inside a copied
                // region adds ~nothing — +0.2% size for +5% speed — and
                // h3 stores were a third of interior insert cost)
                int64_t match_end = (i - 1) + prev_match_len;
                for (int64_t j = i; j < match_end && j + 4 <= total_len; ++j) {
                    uint32_t jh4 = defl_h4(buf + j);
                    s->prev[j & (DEFL_WIN - 1)] = s->head4[jh4];
                    s->head4[jh4] = (int32_t)j;
                }
                i = match_end;
                have_prev = 0;
                continue;
            }
            if (have_prev) {
                // current match longer: previous start byte is a literal
                uint8_t lit = buf[i - 1];
                s->syms[n_syms++] = lit;
                freq_ll[lit]++;
            }
            if (len >= 3 && (len > 3 || dist <= 4096)) {
                miss_run = 0;
                if (pf.lazy && len < pf.max_lazy && i + 1 < chunk_end) {
                    // defer: compare against the match at i+1
                    if (i + 4 <= total_len)
                        defl_insert_h(s, i, h4, h3, pf.use_h3);
                    prev_match_len = len;
                    prev_match_dist = dist;
                    have_prev = 1;
                    ++i;
                    continue;
                }
                int l3 = len - 3;
                int dsym = defl_dist_code(dist);
                s->syms[n_syms++] = 0x80000000u | ((uint32_t)dsym << 24) |
                                    ((uint32_t)l3 << 16) | (uint32_t)dist;
                freq_ll[257 + defl_len_sym[l3]]++;
                freq_d[dsym]++;
                extra_bits += defl_len_extra[l3] + kDistExtra[dsym];
                int64_t match_end = i + len;
                if (i + 4 <= total_len) {
                    if (pf.use_h3) s->head3[h3] = (int32_t)i;
                    s->prev[i & (DEFL_WIN - 1)] = s->head4[h4];
                    s->head4[h4] = (int32_t)i;
                }
                for (int64_t j = i + 1; j < match_end && j + 4 <= total_len; ++j) {
                    uint32_t jh4 = defl_h4(buf + j);
                    s->prev[j & (DEFL_WIN - 1)] = s->head4[jh4];
                    s->head4[jh4] = (int32_t)j;
                }
                i = match_end;
                have_prev = 0;
            } else {
                uint8_t lit = buf[i];
                s->syms[n_syms++] = lit;
                freq_ll[lit]++;
                if (i + 4 <= total_len) defl_insert_h(s, i, h4, h3, pf.use_h3);
                ++i;
                have_prev = 0;
                // Adaptive literal-run skip (libdeflate-style): after 32
                // consecutive match misses the content is behaving like
                // noise, so stride over up to 4 positions emitting literals
                // without probing or updating the hash tables — the random
                // head4/head3 cache lines are what make incompressible
                // regions slow. Any match resets the run, so structured
                // regions resume full-resolution search within a few bytes.
                if (++miss_run >= 32) {
                    int step = miss_run >> 5;
                    if (step > 4) step = 4;
                    int64_t skip_end = i + step;
                    if (skip_end > chunk_end) skip_end = chunk_end;
                    for (; i < skip_end; ++i) {
                        uint8_t l2 = buf[i];
                        s->syms[n_syms++] = l2;
                        freq_ll[l2]++;
                    }
                }
            }
        }
        if (have_prev) {  // deferred match pending at chunk end: emit it
            int l3 = prev_match_len - 3;
            int dsym = defl_dist_code(prev_match_dist);
            s->syms[n_syms++] = 0x80000000u | ((uint32_t)dsym << 24) |
                                ((uint32_t)l3 << 16) |
                                (uint32_t)prev_match_dist;
            freq_ll[257 + defl_len_sym[l3]]++;
            freq_d[dsym]++;
            extra_bits += defl_len_extra[l3] + kDistExtra[dsym];
        }
        rc = defl_emit_block(&bw, buf, raw_start, chunk_end, s->syms, n_syms,
                             freq_ll, freq_d, extra_bits, final_block,
                             cap_end);
        if (rc < 0) return -1;
        pos = chunk_end;
    }
    if (!is_final) {
        // Z_SYNC_FLUSH: empty stored block, byte-aligns the stream
        if (bw.out + 8 > cap_end) return -1;
        defl_putbits(&bw, 0u, 1);
        defl_putbits(&bw, 0u, 2);
        defl_align(&bw);
        bw.out[0] = 0x00;
        bw.out[1] = 0x00;
        bw.out[2] = 0xFF;
        bw.out[3] = 0xFF;
        bw.out += 4;
    } else {
        defl_align(&bw);
    }
    return (int64_t)(bw.out - out);
}

}  // extern "C" (deflate)

// ---------------------------------------------------------------------------
// Adler-32 (RFC 1950) via AVX2: the strict/buffer integrity posture
// (reference's runtime zlib always verifies Adler) priced at ~2.6x less
// than glibc-zlib. Standard SAD/MADDUBS split: for a chunk of m = 32*B
// bytes, s1' = s1 + S and s2' = s2 + m*s1 + W, with S (total byte sum)
// and W (position-weighted sum) vector-accumulated.
// ---------------------------------------------------------------------------

extern "C" {

uint32_t stitch_adler32(const uint8_t* p, int64_t n, uint32_t adler_in) {
    uint32_t s1 = adler_in & 0xFFFF;
    uint32_t s2 = (adler_in >> 16) & 0xFFFF;
    const uint32_t MOD = 65521;
#if defined(__AVX2__)
    const __m256i ones16 = _mm256_set1_epi16(1);
    const __m256i zero = _mm256_setzero_si256();
    // Per-block weights: byte j (0-based) of a 32-byte block contributes
    // (32 - j) * byte within the block.
    const __m256i weights = _mm256_setr_epi8(
        32, 31, 30, 29, 28, 27, 26, 25, 24, 23, 22, 21, 20, 19, 18, 17,
        16, 15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1);
    while (n >= 32) {
        // W = 32*sum_k prefix-blocksums + sum_k in-block weighted sums
        // (vs2_hi: 4x64 lanes; vs2_lo: 8x32 lanes). Chunk 4096 keeps the
        // scalar accumulation below 2^32 before the mod.
        int64_t chunk = n > 4096 ? 4096 : (n & ~31LL);
        int64_t blocks = chunk >> 5;
        __m256i vs1 = zero;     // 4x64 running byte sum (SAD lanes)
        __m256i vs2_hi = zero;  // 4x64 sum of 32*prefix byte sums
        __m256i vs2_lo = zero;  // 8x32 sum of in-block weighted sums
        for (int64_t b = 0; b < blocks; ++b) {
            __m256i v = _mm256_loadu_si256((const __m256i*)p);
            p += 32;
            vs2_hi = _mm256_add_epi64(vs2_hi, _mm256_slli_epi64(vs1, 5));
            vs1 = _mm256_add_epi64(vs1, _mm256_sad_epu8(v, zero));
            vs2_lo = _mm256_add_epi32(
                vs2_lo,
                _mm256_madd_epi16(_mm256_maddubs_epi16(v, weights), ones16));
        }
        uint64_t l1[4], lhi[4];
        uint32_t llo[8];
        _mm256_storeu_si256((__m256i*)l1, vs1);
        _mm256_storeu_si256((__m256i*)lhi, vs2_hi);
        _mm256_storeu_si256((__m256i*)llo, vs2_lo);
        uint64_t S = l1[0] + l1[1] + l1[2] + l1[3];
        uint64_t W = (lhi[0] + lhi[1] + lhi[2] + lhi[3]) + llo[0] + llo[1] +
                     llo[2] + llo[3] + llo[4] + llo[5] + llo[6] + llo[7];
        s2 = (uint32_t)((s2 + (uint64_t)chunk * s1 + W) % MOD);
        s1 = (uint32_t)((s1 + S) % MOD);
        n -= chunk;
    }
#endif
    while (n > 0) {
        int64_t chunk = n > 5552 ? 5552 : n;
        n -= chunk;
        while (chunk-- > 0) {
            s1 += *p++;
            s2 += s1;
        }
        s1 %= MOD;
        s2 %= MOD;
    }
    return (s2 << 16) | s1;
}

// RGB8 -> RGBA8 expansion (alpha = 255). Feeds two hot paths: the PIL
// JPEG tier (decode to mode "RGB" and skip PIL's whole-image convert —
// 25% fewer bytes through tobytes) and convert_band's color-type-2 fast
// path (reference convertScanline RGB arm, pixel-ops.ts:520-560, which
// numpy serves with a strided 3->4 assign). 8 px per AVX2 iteration: two
// 128-bit loads place px 0-3 / 4-5(+) in separate lanes so the in-lane
// vpshufb can expand both.
void stitch_rgb_to_rgba(const uint8_t* rgb, uint8_t* rgba, int64_t n_px) {
    int64_t i = 0;
#if defined(__AVX2__)
    const __m256i shuf = _mm256_setr_epi8(
        0, 1, 2, -1, 3, 4, 5, -1, 6, 7, 8, -1, 9, 10, 11, -1,
        0, 1, 2, -1, 3, 4, 5, -1, 6, 7, 8, -1, 9, 10, 11, -1);
    const __m256i alpha = _mm256_set1_epi32((int)0xFF000000u);
    // Each iteration loads 16 bytes from rgb+3i and rgb+3i+12 (consumes
    // 24, touches 28): stay >= 10 px from the end so the overread stays
    // inside the buffer; the scalar tail finishes the rest.
    for (; n_px - i >= 10; i += 8) {
        const uint8_t* p = rgb + 3 * i;
        __m256i v = _mm256_inserti128_si256(
            _mm256_castsi128_si256(_mm_loadu_si128((const __m128i*)p)),
            _mm_loadu_si128((const __m128i*)(p + 12)), 1);
        _mm256_storeu_si256(
            (__m256i*)(rgba + 4 * i),
            _mm256_or_si256(_mm256_shuffle_epi8(v, shuf), alpha));
    }
#endif
    for (; i < n_px; ++i) {
        rgba[4 * i + 0] = rgb[3 * i + 0];
        rgba[4 * i + 1] = rgb[3 * i + 1];
        rgba[4 * i + 2] = rgb[3 * i + 2];
        rgba[4 * i + 3] = 255;
    }
}

// Gray8 -> RGBA8 (alpha = 255); the PIL tier's mode-"L" JPEGs and
// convert_band's color-type-0 8-bit arm. 16 px per iteration: broadcast
// each source byte across its pixel's RGB lanes, OR the alpha channel.
void stitch_gray_to_rgba(const uint8_t* g, uint8_t* rgba, int64_t n_px) {
    int64_t i = 0;
#if defined(__AVX2__)
    const __m256i shuf = _mm256_setr_epi8(
        0, 0, 0, -1, 1, 1, 1, -1, 2, 2, 2, -1, 3, 3, 3, -1,
        0, 0, 0, -1, 1, 1, 1, -1, 2, 2, 2, -1, 3, 3, 3, -1);
    const __m256i alpha = _mm256_set1_epi32((int)0xFF000000u);
    for (; n_px - i >= 16; i += 16) {
        __m128i s = _mm_loadu_si128((const __m128i*)(g + i));
        // px 0-3 | 4-7 in lanes, then px 8-11 | 12-15.
        __m256i lo = _mm256_inserti128_si256(
            _mm256_castsi128_si256(s), _mm_srli_si128(s, 4), 1);
        __m256i hi = _mm256_inserti128_si256(
            _mm256_castsi128_si256(_mm_srli_si128(s, 8)),
            _mm_srli_si128(s, 12), 1);
        _mm256_storeu_si256(
            (__m256i*)(rgba + 4 * i),
            _mm256_or_si256(_mm256_shuffle_epi8(lo, shuf), alpha));
        _mm256_storeu_si256(
            (__m256i*)(rgba + 4 * i + 32),
            _mm256_or_si256(_mm256_shuffle_epi8(hi, shuf), alpha));
    }
#endif
    for (; i < n_px; ++i) {
        uint8_t v = g[i];
        rgba[4 * i + 0] = v;
        rgba[4 * i + 1] = v;
        rgba[4 * i + 2] = v;
        rgba[4 * i + 3] = 255;
    }
}

}  // extern "C" (checksums)

// ===========================================================================
// JPEG decode finish: dequantize + integer islow IDCT with direct plane
// writes, and fixed-point YCbCr->RGB. Exact int64 mirror of the numpy tier
// (codecs/jpeg/libjpeg_exact.py — itself jidctint.c/jdcolor.c semantics,
// reference parity target: jpeg-decoder.ts's jpeg-js fallback). Every
// arithmetic step matches the numpy ops (int64 products, round-half
// DESCALE, &1023 post-IDCT range mask) so the tiers are bit-identical by
// construction; the lookup tables are PASSED IN from the Python module so
// there is exactly one table definition.
// ===========================================================================

extern "C" {

static inline int64_t jdescale(int64_t x, int n) {
    return (x + ((int64_t)1 << (n - 1))) >> n;
}

// One dequant+IDCT block: b = 64 natural-order int32 coefficients,
// q = 64 int32 quantizer steps, post = the 1024-entry post-IDCT range
// table, out = top-left sample of this block in a plane of `ostride`
// bytes per row.
static void jpeg_idct_islow_block(const int32_t* b, const int32_t* q,
                                  const uint8_t* post, uint8_t* out,
                                  int64_t ostride) {
    int64_t ws[64];
    // Column pass (CONST_BITS=13, PASS1_BITS=2).
    for (int c = 0; c < 8; ++c) {
        const int64_t i0 = (int64_t)b[0 * 8 + c] * q[0 * 8 + c];
        const int64_t i1 = (int64_t)b[1 * 8 + c] * q[1 * 8 + c];
        const int64_t i2 = (int64_t)b[2 * 8 + c] * q[2 * 8 + c];
        const int64_t i3 = (int64_t)b[3 * 8 + c] * q[3 * 8 + c];
        const int64_t i4 = (int64_t)b[4 * 8 + c] * q[4 * 8 + c];
        const int64_t i5 = (int64_t)b[5 * 8 + c] * q[5 * 8 + c];
        const int64_t i6 = (int64_t)b[6 * 8 + c] * q[6 * 8 + c];
        const int64_t i7 = (int64_t)b[7 * 8 + c] * q[7 * 8 + c];

        int64_t z1 = (i2 + i6) * 4433;           // FIX_0_541196100
        int64_t tmp2 = z1 - i6 * 15137;          // FIX_1_847759065
        int64_t tmp3 = z1 + i2 * 6270;           // FIX_0_765366865
        int64_t tmp0 = (i0 + i4) << 13;
        int64_t tmp1 = (i0 - i4) << 13;
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

        int64_t t0 = i7, t1 = i5, t2 = i3, t3 = i1;
        z1 = t0 + t3;
        int64_t z2 = t1 + t2;
        int64_t z3 = t0 + t2;
        int64_t z4 = t1 + t3;
        int64_t z5 = (z3 + z4) * 9633;           // FIX_1_175875602
        t0 *= 2446;                               // FIX_0_298631336
        t1 *= 16819;                              // FIX_2_053119869
        t2 *= 25172;                              // FIX_3_072711026
        t3 *= 12299;                              // FIX_1_501321110
        z1 *= -7373;                              // -FIX_0_899976223
        z2 *= -20995;                             // -FIX_2_562915447
        z3 = z3 * -16069 + z5;                    // -FIX_1_961570560
        z4 = z4 * -3196 + z5;                     // -FIX_0_390180644
        t0 += z1 + z3;
        t1 += z2 + z4;
        t2 += z2 + z3;
        t3 += z1 + z4;

        ws[0 * 8 + c] = jdescale(tmp10 + t3, 11);
        ws[7 * 8 + c] = jdescale(tmp10 - t3, 11);
        ws[1 * 8 + c] = jdescale(tmp11 + t2, 11);
        ws[6 * 8 + c] = jdescale(tmp11 - t2, 11);
        ws[2 * 8 + c] = jdescale(tmp12 + t1, 11);
        ws[5 * 8 + c] = jdescale(tmp12 - t1, 11);
        ws[3 * 8 + c] = jdescale(tmp13 + t0, 11);
        ws[4 * 8 + c] = jdescale(tmp13 - t0, 11);
    }
    // Row pass (descale CONST_BITS+PASS1_BITS+3 = 18) + range limit.
    for (int r = 0; r < 8; ++r) {
        const int64_t* w = ws + r * 8;
        int64_t z1 = (w[2] + w[6]) * 4433;
        int64_t tmp2 = z1 - w[6] * 15137;
        int64_t tmp3 = z1 + w[2] * 6270;
        int64_t tmp0 = (w[0] + w[4]) << 13;
        int64_t tmp1 = (w[0] - w[4]) << 13;
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

        int64_t t0 = w[7], t1 = w[5], t2 = w[3], t3 = w[1];
        z1 = t0 + t3;
        int64_t z2 = t1 + t2;
        int64_t z3 = t0 + t2;
        int64_t z4 = t1 + t3;
        int64_t z5 = (z3 + z4) * 9633;
        t0 *= 2446;
        t1 *= 16819;
        t2 *= 25172;
        t3 *= 12299;
        z1 *= -7373;
        z2 *= -20995;
        z3 = z3 * -16069 + z5;
        z4 = z4 * -3196 + z5;
        t0 += z1 + z3;
        t1 += z2 + z4;
        t2 += z2 + z3;
        t3 += z1 + z4;

        uint8_t* o = out + r * ostride;
        o[0] = post[(uint64_t)(jdescale(tmp10 + t3, 18)) & 1023];
        o[7] = post[(uint64_t)(jdescale(tmp10 - t3, 18)) & 1023];
        o[1] = post[(uint64_t)(jdescale(tmp11 + t2, 18)) & 1023];
        o[6] = post[(uint64_t)(jdescale(tmp11 - t2, 18)) & 1023];
        o[2] = post[(uint64_t)(jdescale(tmp12 + t1, 18)) & 1023];
        o[5] = post[(uint64_t)(jdescale(tmp12 - t1, 18)) & 1023];
        o[3] = post[(uint64_t)(jdescale(tmp13 + t0, 18)) & 1023];
        o[4] = post[(uint64_t)(jdescale(tmp13 - t0, 18)) & 1023];
    }
}

// Whole component plane: blocks (by*bx, 64) natural-order int32, written
// as (by*8, bx*8) uint8 samples directly (no block-array staging or
// transpose copies — the numpy tier pays both).
void jpeg_idct_plane(const int32_t* blocks, const int32_t* qtab,
                     int64_t by, int64_t bx, const uint8_t* post,
                     uint8_t* plane) {
    const int64_t stride = bx * 8;
    for (int64_t r = 0; r < by; ++r)
        for (int64_t c = 0; c < bx; ++c)
            jpeg_idct_islow_block(blocks + ((r * bx + c) << 6), qtab, post,
                                  plane + r * 8 * stride + c * 8, stride);
}

// Fixed-point YCbCr->RGB (jdcolor.c SCALEBITS=16 tables, passed in as
// int32; clamp = the 1408-entry range table, indexed value+256). Row
// strides are in bytes so cropped plane views convert copy-free.
void jpeg_ycc_rgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                  int64_t h, int64_t w,
                  int64_t sy, int64_t scb, int64_t scr,
                  const int32_t* cr_r, const int32_t* cb_b,
                  const int32_t* cr_g, const int32_t* cb_g,
                  const uint8_t* clamp, uint8_t* rgb) {
    for (int64_t r = 0; r < h; ++r) {
        const uint8_t* yr = y + r * sy;
        const uint8_t* cbr = cb + r * scb;
        const uint8_t* crr = cr + r * scr;
        uint8_t* o = rgb + r * w * 3;
        for (int64_t i = 0; i < w; ++i) {
            const int32_t yv = yr[i];
            const int32_t cbv = cbr[i];
            const int32_t crv = crr[i];
            o[3 * i + 0] = clamp[yv + cr_r[crv] + 256];
            o[3 * i + 1] = clamp[yv + ((cb_g[cbv] + cr_g[crv]) >> 16) + 256];
            o[3 * i + 2] = clamp[yv + cb_b[cbv] + 256];
        }
    }
}

// Fancy (triangular) chroma upsamplers, exact mirrors of jdsample.c /
// libjpeg_exact.py. Input plane (h, w) with row stride `sp` bytes.
// h2v1: out (h, 2w); h2v2: out (2h, 2w), both C-contiguous.
void jpeg_h2v1_upsample(const uint8_t* p, int64_t h, int64_t w, int64_t sp,
                        uint8_t* out) {
    for (int64_t r = 0; r < h; ++r) {
        const uint8_t* in = p + r * sp;
        uint8_t* o = out + r * 2 * w;
        for (int64_t c = 0; c < w; ++c) {
            const int32_t v3 = in[c] * 3;
            const int32_t left = in[c > 0 ? c - 1 : 0];
            const int32_t right = in[c < w - 1 ? c + 1 : w - 1];
            o[2 * c] = (uint8_t)((v3 + left + 1) >> 2);
            o[2 * c + 1] = (uint8_t)((v3 + right + 2) >> 2);
        }
        o[0] = in[0];
        o[2 * w - 1] = in[w - 1];
    }
}

void jpeg_h2v2_upsample(const uint8_t* p, int64_t h, int64_t w, int64_t sp,
                        uint8_t* out) {
    for (int64_t r = 0; r < h; ++r) {
        const uint8_t* in = p + r * sp;
        const uint8_t* up = p + (r > 0 ? r - 1 : 0) * sp;
        const uint8_t* dn = p + (r < h - 1 ? r + 1 : h - 1) * sp;
        for (int phase = 0; phase < 2; ++phase) {
            const uint8_t* adj = phase == 0 ? up : dn;
            uint8_t* o = out + (r * 2 + phase) * 2 * w;
            // colsum[c] = in[c]*3 + adj[c]; edges replicate colsum.
            int32_t cs_prev = in[0] * 3 + adj[0];
            int32_t cs = cs_prev;
            for (int64_t c = 0; c < w; ++c) {
                const int32_t cs_next =
                    c < w - 1 ? in[c + 1] * 3 + adj[c + 1] : cs;
                o[2 * c] = (uint8_t)((cs * 3 + cs_prev + 8) >> 4);
                o[2 * c + 1] = (uint8_t)((cs * 3 + cs_next + 7) >> 4);
                cs_prev = cs;
                cs = cs_next;
            }
            const int32_t cs0 = in[0] * 3 + adj[0];
            const int32_t csl = in[w - 1] * 3 + adj[w - 1];
            o[0] = (uint8_t)((cs0 * 4 + 8) >> 4);
            o[2 * w - 1] = (uint8_t)((csl * 4 + 7) >> 4);
        }
    }
}

}  // extern "C" (jpeg decode finish)

// ===========================================================================
// Progressive JPEG scan decode (T.81 G.2, structure mirrors jdphuff.c and
// the Python tier owned_decoder._decode_progressive_scan — which remains
// the fallback and parity oracle). One call decodes one scan into the
// persistent coefficient arrays; the Python marker walk stays in Python.
// ===========================================================================

extern "C" {

static inline int br_take1(BitReader* br) {
    if (br->n < 1) br_fill(br);
    br->n -= 1;
    return (int)((br->bb >> br->n) & 1);
}

// blocks0..3: per-SCAN-component coefficient arrays ((by*bx, 64) int32).
// sc_*: per-scan-component sampling (h, v), row stride in blocks (bx),
// and single-component block-grid bounds (wb, hb). interleaved selects
// MCU order (DC scans; AC scans are always single-component).
int jpeg_decode_progressive_scan(
    const uint8_t* data, int64_t data_len, int64_t scan_start,
    int n_scan, const int* sc_h, const int* sc_v, const int* sc_bx,
    const int* sc_wb, const int* sc_hb,
    const HuffDecTable* dc_tables, const HuffDecTable* ac_tables,
    const int* dc_sel, const int* ac_sel,
    int mcux, int mcuy, int restart_interval, int interleaved,
    int ss, int se, int ah, int al,
    int32_t* blocks0, int32_t* blocks1, int32_t* blocks2, int32_t* blocks3) {
    int32_t* blocks_c[4] = {blocks0, blocks1, blocks2, blocks3};
    if (n_scan < 1 || n_scan > 4 || se > 63 || ss < 0 || al > 13) return -10;
    BitReader br = {data + scan_start, data_len - scan_start, 0, 0, 0};
    int32_t preds[4] = {0, 0, 0, 0};
    int64_t eobrun = 0;
    const int32_t p1 = (int32_t)1 << al;
    const int32_t m1 = -p1;

    HuffFastLut dc_luts[4], ac_luts[4];
    int built_dc[4] = {0, 0, 0, 0}, built_ac[4] = {0, 0, 0, 0};
    if (ss == 0 && ah == 0) {
        for (int c = 0; c < n_scan; ++c) {
            const int d = dc_sel[c];
            if (d < 0 || d > 3) return -6;
            if (!built_dc[d]) {
                build_fast_lut(dc_tables + d, &dc_luts[d]);
                built_dc[d] = 1;
            }
        }
    }
    if (ss > 0) {
        const int a = ac_sel[0];
        if (a < 0 || a > 3) return -6;
        build_fast_lut(ac_tables + a, &ac_luts[a]);
        built_ac[a] = 1;
    }

    if (ss == 0) {
        if (se != 0) return -11;
        int64_t unit = 0;
        if (interleaved) {
            for (int my = 0; my < mcuy; ++my) {
                for (int mx = 0; mx < mcux; ++mx) {
                    if (restart_interval && unit &&
                        unit % restart_interval == 0) {
                        if (br_sync_restart(&br) != 0) return -2;
                        preds[0] = preds[1] = preds[2] = preds[3] = 0;
                    }
                    for (int c = 0; c < n_scan; ++c) {
                        for (int v = 0; v < sc_v[c]; ++v) {
                            for (int h = 0; h < sc_h[c]; ++h) {
                                int32_t* blk = blocks_c[c] +
                                    ((int64_t)(my * sc_v[c] + v) * sc_bx[c] +
                                     (mx * sc_h[c] + h)) * 64;
                                if (ah == 0) {
                                    if (br.n < 32) br_fill(&br);
                                    int s = huff_decode(&br, dc_tables + dc_sel[c],
                                                        &dc_luts[dc_sel[c]]);
                                    if (s < 0 || s > 16) return -3;
                                    preds[c] += extend_val(br_take(&br, s), s);
                                    blk[0] = preds[c] << al;
                                } else {
                                    blk[0] |= (int32_t)br_take1(&br) << al;
                                }
                            }
                        }
                    }
                    ++unit;
                }
            }
        } else {
            const int wb = sc_wb[0], hb = sc_hb[0];
            for (int by = 0; by < hb; ++by) {
                for (int bx = 0; bx < wb; ++bx) {
                    if (restart_interval && unit &&
                        unit % restart_interval == 0) {
                        if (br_sync_restart(&br) != 0) return -2;
                        preds[0] = 0;
                    }
                    int32_t* blk =
                        blocks_c[0] + ((int64_t)by * sc_bx[0] + bx) * 64;
                    if (ah == 0) {
                        if (br.n < 32) br_fill(&br);
                        int s = huff_decode(&br, dc_tables + dc_sel[0],
                                            &dc_luts[dc_sel[0]]);
                        if (s < 0 || s > 16) return -3;
                        preds[0] += extend_val(br_take(&br, s), s);
                        blk[0] = preds[0] << al;
                    } else {
                        blk[0] |= (int32_t)br_take1(&br) << al;
                    }
                    ++unit;
                }
            }
        }
        return 0;
    }

    // AC scans: single component, block order over (hb, wb).
    if (interleaved || n_scan != 1) return -12;
    const HuffDecTable* act = ac_tables + ac_sel[0];
    const HuffFastLut* acf = &ac_luts[ac_sel[0]];
    const int wb = sc_wb[0], hb = sc_hb[0];
    int64_t unit = 0;
    for (int by = 0; by < hb; ++by) {
        for (int bx = 0; bx < wb; ++bx) {
            if (restart_interval && unit && unit % restart_interval == 0) {
                if (br_sync_restart(&br) != 0) return -2;
                eobrun = 0;
            }
            int32_t* blk = blocks_c[0] + ((int64_t)by * sc_bx[0] + bx) * 64;
            if (ah == 0) {
                // AC first scan (blk[zz] = extend << al; EOB runs).
                if (eobrun > 0) {
                    --eobrun;
                } else {
                    int k = ss;
                    while (k <= se) {
                        if (br.n < 32) br_fill(&br);
                        int rs = huff_decode(&br, act, acf);
                        if (rs < 0) return -4;
                        int r = rs >> 4, s = rs & 0x0F;
                        if (s == 0) {
                            if (r < 15) {
                                eobrun = ((int64_t)1 << r) - 1;
                                if (r) eobrun += br_take(&br, r);
                                break;
                            }
                            k += 16;
                            continue;
                        }
                        k += r;
                        if (k > se) return -5;
                        blk[kZigzag[k]] =
                            (int32_t)(extend_val(br_take(&br, s), s)) << al;
                        k += 1;
                    }
                }
            } else {
                // AC refinement scan (jdphuff decode_mcu_AC_refine shape;
                // every nonzero-history coefficient consumes a bit).
                int k = ss;
                if (eobrun == 0) {
                    while (k <= se) {
                        if (br.n < 32) br_fill(&br);
                        int rs = huff_decode(&br, act, acf);
                        if (rs < 0) return -4;
                        int r = rs >> 4, s = rs & 0x0F;
                        int32_t val = 0;
                        if (s == 0) {
                            if (r < 15) {
                                eobrun = (int64_t)1 << r;
                                if (r) eobrun += br_take(&br, r);
                                break;
                            }
                            // r == 15: pass 16 zero-history coefficients.
                        } else {
                            val = br_take1(&br) ? p1 : m1;
                        }
                        while (k <= se) {
                            const int z = kZigzag[k];
                            if (blk[z] != 0) {
                                if (br_take1(&br) && (blk[z] & p1) == 0)
                                    blk[z] += blk[z] >= 0 ? p1 : m1;
                            } else {
                                if (--r < 0) break;
                            }
                            k += 1;
                        }
                        if (val && k <= se) blk[kZigzag[k]] = val;
                        k += 1;
                    }
                }
                if (eobrun > 0) {
                    for (; k <= se; ++k) {
                        const int z = kZigzag[k];
                        if (blk[z] != 0) {
                            if (br_take1(&br) && (blk[z] & p1) == 0)
                                blk[z] += blk[z] >= 0 ? p1 : m1;
                        }
                    }
                    --eobrun;
                }
            }
            ++unit;
        }
    }
    return 0;
}

}  // extern "C" (progressive scan decode)
