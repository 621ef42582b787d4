"""Plain NumPy baseline JPEG encoder: the semantics the stitched output
must have, written from ITU-T T.81 and the IJG conventions, independent of
the program under test.

- Colour: integer YCbCr in 16-bit fixed point (JFIF), rounded by adding
  one half; Cb and Cr may reach 256 on saturated blue or red and are not
  clamped.
- Transform: libjpeg's accurate integer FDCT (jfdctint, ``JDCT_ISLOW``:
  CONST_BITS 13, PASS1_BITS 2) on level-shifted samples. Each of its two
  passes is an integer linear map followed by a rounding shift, so it is
  computed here as a float64 matrix product, which is exact at these
  magnitudes (every partial sum stays under 2**40).
- Quantization: libjpeg's exact divide, sign(c) * floor((|c| + 4q) / 8q),
  with the IJG quality scaling of the Annex K tables.
- Entropy coding: the Annex K Huffman tables, one scan, no restart
  markers, 0xFF stuffing, the last byte padded with 1 bits.
- Edges: the last row and column repeat to a whole MCU.

``encode`` codes a whole image in one process; ``encode_rows`` codes a range
of MCU rows, so that ranges can be coded in parallel and joined with
``join_bits``. ``fdct`` takes ``precision="float32"`` for the control: the
same transform computed as a float32 DCT, the step a faster encoder would
be tempted to take.
"""

from __future__ import annotations

import numpy as np

CONST_BITS = 13
PASS1_BITS = 2

STD_LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], np.int64)
STD_CHROMA_QUANT = np.array([17, 18, 24, 47] + [99] * 4 + [18, 21, 26, 66] + [99] * 4
                            + [24, 26, 56] + [99] * 5 + [47, 66] + [99] * 38, np.int64)

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int64)

DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125], bytes([
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
]))
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119], bytes([
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
]))


def quant_tables(quality: int) -> tuple[np.ndarray, np.ndarray]:
    """IJG quality scaling of the Annex K tables, natural order, [1, 255]."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return tuple(np.clip((t * scale + 50) // 100, 1, 255)
                 for t in (STD_LUMA_QUANT, STD_CHROMA_QUANT))


def huffman_codes(spec) -> tuple[np.ndarray, np.ndarray]:
    """Annex C.2 code assignment: dense (code, length) by symbol."""
    counts, symbols = spec
    code_of = np.zeros(256, np.uint64)
    len_of = np.zeros(256, np.int64)
    code = k = 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            code_of[symbols[k]] = code
            len_of[symbols[k]] = length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _islow_pass_matrix(final: bool) -> tuple[np.ndarray, np.ndarray]:
    """The jfdctint pass as (integer matrix M, shift per output): output k
    is (M[k] . d + round) >> shift[k]. Derived by running the butterfly on
    unit vectors, which is exact because every step before the shift is
    linear."""
    fix = dict(a=2446, b=3196, c=4433, d=6270, e=7373, f=9633, g=12299, h=15137,
               i=16069, j=16819, k=20995, l=25172)
    m = np.zeros((8, 8), np.int64)
    for col in range(8):
        d = [int(col == n) for n in range(8)]
        t0, t7, t1, t6 = d[0] + d[7], d[0] - d[7], d[1] + d[6], d[1] - d[6]
        t2, t5, t3, t4 = d[2] + d[5], d[2] - d[5], d[3] + d[4], d[3] - d[4]
        t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
        scale = 1 if final else 1 << PASS1_BITS
        o = [0] * 8
        o[0], o[4] = (t10 + t11) * scale, (t10 - t11) * scale
        z1 = (t12 + t13) * fix["c"]
        o[2], o[6] = z1 + t13 * fix["d"], z1 - t12 * fix["h"]
        z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
        z5 = (z3 + z4) * fix["f"]
        t4, t5, t6, t7 = t4 * fix["a"], t5 * fix["j"], t6 * fix["l"], t7 * fix["g"]
        z1, z2 = z1 * -fix["e"], z2 * -fix["k"]
        z3, z4 = z3 * -fix["i"] + z5, z4 * -fix["b"] + z5
        o[7], o[5], o[3], o[1] = t4 + z1 + z3, t5 + z2 + z4, t6 + z2 + z3, t7 + z1 + z4
        m[:, col] = o
    odd = CONST_BITS + PASS1_BITS if final else CONST_BITS - PASS1_BITS
    even = PASS1_BITS if final else 0
    shift = np.array([even, odd, odd, odd, even, odd, odd, odd], np.int64)
    return m, shift


_PASS1 = _islow_pass_matrix(final=False)
_PASS2 = _islow_pass_matrix(final=True)


def _apply_pass(x: np.ndarray, pass_: tuple[np.ndarray, np.ndarray]) -> np.ndarray:
    """Apply an islow pass along the last axis of float64 ``x``."""
    m, shift = pass_
    y = x @ m.T.astype(np.float64)
    div = np.exp2(shift.astype(np.float64))
    half = np.where(shift > 0, div / 2, 0.0)
    return np.floor((y + half) / div)


def _dct_basis() -> np.ndarray:
    """Orthonormal 8-point DCT-II basis, float64."""
    k = np.arange(8)[:, None]
    n = np.arange(8)[None, :]
    c = np.cos((2 * n + 1) * k * np.pi / 16) * np.sqrt(2 / 8)
    c[0] /= np.sqrt(2)
    return c


def fdct(blocks: np.ndarray, precision: str = "islow") -> np.ndarray:
    """(N, 8, 8) level-shifted samples -> (N, 8, 8) coefficients scaled by 8
    ([u, v]: vertical, horizontal frequency). ``islow`` is exact;
    ``float32`` is the control's float DCT, rounded to integers."""
    x = blocks.astype(np.float64)
    if precision == "islow":
        rows = _apply_pass(x, _PASS1)                                  # along v
        cols = _apply_pass(np.swapaxes(rows, 1, 2), _PASS2)            # along u
        return np.swapaxes(cols, 1, 2).astype(np.int64)
    if precision == "float32":
        c = _dct_basis().astype(np.float32)
        y = (c @ x.astype(np.float32) @ c.T) * np.float32(8.0)
        return np.rint(y).astype(np.int64)
    raise ValueError(f"unknown precision {precision!r}")


def ycbcr(rgb: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(H, W, >=3) uint8 -> Y, Cb, Cr int64 planes (16-bit fixed point)."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half = 1 << 15
    y = (19595 * r + 38470 * g + 7471 * b + half) >> 16
    cb = (-11059 * r - 21709 * g + 32768 * b + half + (128 << 16)) >> 16
    cr = (32768 * r - 27439 * g - 5329 * b + half + (128 << 16)) >> 16
    return y, cb, cr


def quantize(coef8: np.ndarray, q: np.ndarray) -> np.ndarray:
    """libjpeg's exact quantizer on coefficients scaled by 8."""
    q = q.reshape(8, 8)
    mag = (np.abs(coef8) + 4 * q) // (8 * q)
    return np.where(coef8 < 0, -mag, mag)


def plane_blocks(plane: np.ndarray, q: np.ndarray, precision: str = "islow") -> np.ndarray:
    """(8a, 8b) plane -> (a*b, 64) quantized zigzag-ordered blocks, raster
    order."""
    h, w = plane.shape
    blocks = (plane - 128).reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
    quant = quantize(fdct(blocks, precision), q).reshape(-1, 64)
    return quant[:, ZIGZAG]


def pad_to(rgb: np.ndarray, mh: int, mw: int) -> np.ndarray:
    """Repeat the last row and column up to multiples of (mh, mw)."""
    h, w = rgb.shape[:2]
    return np.pad(rgb, ((0, (-h) % mh), (0, (-w) % mw), (0, 0)), mode="edge")


def mcu_blocks(rgb: np.ndarray, quality: int, sampling: str,
               precision: str = "islow") -> tuple[np.ndarray, np.ndarray]:
    """Quantized zigzag blocks of whole MCU rows, in scan order, and the
    component of each block (0 Y, 1 Cb, 2 Cr). ``rgb`` is already padded to
    whole MCUs."""
    lq, cq = quant_tables(quality)
    y, cb, cr = ycbcr(rgb)
    h, w = y.shape
    if sampling == "444":
        parts = [plane_blocks(p, t, precision) for p, t in ((y, lq), (cb, cq), (cr, cq))]
        blocks = np.stack(parts, axis=1).reshape(-1, 64)
        comp = np.tile(np.arange(3), len(parts[0]))
        return blocks, comp
    if sampling == "420":
        yb = plane_blocks(y, lq, precision).reshape(h // 16, 2, w // 16, 2, 64)
        yb = yb.transpose(0, 2, 1, 3, 4).reshape(-1, 4, 64)

        def sub(c):
            return (c.reshape(h // 2, 2, w // 2, 2).sum(axis=(1, 3)) + 2) >> 2

        cbb = plane_blocks(sub(cb), cq, precision)[:, None]
        crb = plane_blocks(sub(cr), cq, precision)[:, None]
        blocks = np.concatenate([yb, cbb, crb], axis=1).reshape(-1, 64)
        comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), len(cbb))
        return blocks, comp
    raise ValueError(f"unknown sampling {sampling!r}")


def _bit_length(v: np.ndarray) -> np.ndarray:
    """JPEG magnitude category: bits of |v| (0 for 0)."""
    mag = np.abs(v).astype(np.int64)
    size = np.zeros(mag.shape, np.int64)
    for b in range(16):
        size += mag >= (1 << b)
    return size


def _amplitude(v: np.ndarray, size: np.ndarray) -> np.ndarray:
    """The ``size`` low bits that code ``v`` (one's complement if < 0)."""
    return np.where(v < 0, v + (1 << size) - 1, v).astype(np.int64) & ((1 << size) - 1)


def entropy_words(blocks: np.ndarray, comp: np.ndarray,
                  prev_dc: tuple[int, int, int] = (0, 0, 0)) -> tuple[np.ndarray, np.ndarray]:
    """Huffman code the blocks in scan order: (values, lengths), one word
    per DC, per nonzero AC (its ZRL runs, code and amplitude joined, at
    most 59 bits) and per EOB, in stream order."""
    tables = [(huffman_codes(DC_LUMA), huffman_codes(AC_LUMA)),
              (huffman_codes(DC_CHROMA), huffman_codes(AC_CHROMA))]
    chroma = (comp > 0).astype(np.int64)
    n = len(blocks)
    dc = blocks[:, 0].astype(np.int64)
    diff = np.empty(n, np.int64)
    for c in range(3):
        idx = np.nonzero(comp == c)[0]
        if len(idx):
            d = dc[idx]
            diff[idx] = d - np.concatenate([[prev_dc[c]], d[:-1]])
    dsize = _bit_length(diff)
    dc_code = np.where(chroma, tables[1][0][0][dsize], tables[0][0][0][dsize])
    dc_len = np.where(chroma, tables[1][0][1][dsize], tables[0][0][1][dsize])
    dc_val = (dc_code.astype(np.int64) << dsize) | _amplitude(diff, dsize)
    dc_bits = dc_len + dsize

    ac = blocks[:, 1:]
    blk, pos = np.nonzero(ac)                    # row-major: by block, then position
    pos = pos + 1                                # zigzag index 1..63
    nnz = np.bincount(blk, minlength=n)
    first = np.cumsum(nnz) - nnz
    rank = np.arange(len(blk)) - first[blk]
    prev_pos = np.where(rank == 0, 0, np.roll(pos, 1))
    run = pos - prev_pos - 1
    v = ac[blk, pos - 1].astype(np.int64)
    size = _bit_length(v)
    sym = ((run & 15) << 4) | size
    ch = chroma[blk]
    ac_code = np.where(ch, tables[1][1][0][sym], tables[0][1][0][sym]).astype(np.int64)
    ac_len = np.where(ch, tables[1][1][1][sym], tables[0][1][1][sym])
    zrl_code = np.where(ch, tables[1][1][0][0xF0], tables[0][1][0][0xF0]).astype(np.int64)
    zrl_len = np.where(ch, tables[1][1][1][0xF0], tables[0][1][1][0xF0])
    nzrl = run >> 4
    val = np.zeros(len(blk), np.int64)
    bits = np.zeros(len(blk), np.int64)
    for k in range(3):
        has = nzrl > k
        val = np.where(has, (val << zrl_len) | zrl_code, val)
        bits = np.where(has, bits + zrl_len, bits)
    val = (((val << ac_len) | ac_code) << size) | _amplitude(v, size)
    bits = bits + ac_len + size

    last = np.zeros(n, np.int64)
    last[blk] = pos                               # the last write per block wins
    eob = last != 63
    eob_code = np.where(chroma, tables[1][1][0][0], tables[0][1][0][0]).astype(np.int64)
    eob_len = np.where(chroma, tables[1][1][1][0], tables[0][1][1][0])

    words = 1 + nnz + eob
    start = np.cumsum(words) - words
    total = int(words.sum())
    out_v = np.zeros(total, np.int64)
    out_n = np.zeros(total, np.int64)
    out_v[start], out_n[start] = dc_val, dc_bits
    ai = start[blk] + 1 + rank
    out_v[ai], out_n[ai] = val, bits
    ei = (start + 1 + nnz)[eob]
    out_v[ei], out_n[ei] = eob_code[eob], eob_len[eob]
    return out_v.astype(np.uint64), out_n


def pack_bits(values: np.ndarray, lengths: np.ndarray) -> tuple[np.ndarray, int]:
    """Pack words (each at most 59 bits) MSB first: (bytes, bit count), the
    last byte's unused low bits zero. No stuffing."""
    lengths = lengths.astype(np.int64)
    nbits = int(lengths.sum())
    if nbits == 0:
        return np.zeros(0, np.uint8), 0
    off = np.cumsum(lengths) - lengths
    word = off >> 6
    s = off & 63
    end = s + lengths
    out = np.zeros((nbits >> 6) + 2, np.uint64)
    fits = end <= 64
    hi = np.where(fits, values << (64 - end).clip(0, 63).astype(np.uint64),
                  values >> (end - 64).clip(0, 63).astype(np.uint64))
    hi = np.where(lengths == 0, np.uint64(0), hi)
    starts = np.flatnonzero(np.r_[True, word[1:] != word[:-1]])
    out[word[starts]] = np.bitwise_or.reduceat(hi, starts)
    spill = ~fits
    lo = values[spill] << (128 - end[spill]).astype(np.uint64)
    out[word[spill] + 1] |= lo
    data = out.astype(">u8").view(np.uint8)
    return data[: (nbits + 7) >> 3].copy(), nbits


def join_bits(parts: list[tuple[np.ndarray, int]]) -> tuple[np.ndarray, int]:
    """Concatenate MSB-first bit strings given as (bytes, bit count)."""
    chunks: list[np.ndarray] = []
    carry, m = 0, 0                       # pending high bits of a partial byte
    for data, n in parts:
        if n == 0:
            continue
        data = data[: (n + 7) >> 3].astype(np.uint16)
        total = m + n
        q = np.zeros(len(data) + 1, np.uint16)
        q[0] = carry << (8 - m) if m else 0
        q[: len(data)] |= data >> m
        q[1: len(data) + 1] |= (data << (8 - m)) & 0xFF
        full = total >> 3
        chunks.append(q[:full].astype(np.uint8))
        m = total & 7
        carry = int(q[full]) >> (8 - m) if m else 0
    if m:
        chunks.append(np.array([carry << (8 - m)], np.uint8))
    data = np.concatenate(chunks) if chunks else np.zeros(0, np.uint8)
    return data, sum(n for _, n in parts)


def finish_scan(data: np.ndarray, nbits: int) -> bytes:
    """Pad the last byte with 1 bits and stuff a 0x00 after every 0xFF."""
    data = data.copy()
    if nbits & 7:
        data[-1] |= (1 << (8 - (nbits & 7))) - 1
    ff = np.flatnonzero(data == 0xFF)
    return np.insert(data, ff + 1, 0).tobytes()


def header(width: int, height: int, quality: int, sampling: str) -> bytes:
    """SOI, JFIF APP0, the two DQTs, SOF0, the four DHTs and SOS."""
    def seg(marker: int, payload: bytes) -> bytes:
        return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload

    lq, cq = quant_tables(quality)
    out = b"\xff\xd8" + seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for tid, q in ((0, lq), (1, cq)):
        out += seg(0xDB, bytes([tid]) + bytes(int(v) for v in q[ZIGZAG]))
    y_hv = 0x22 if sampling == "420" else 0x11
    out += seg(0xC0, bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big")
               + bytes([3, 1, y_hv, 0, 2, 0x11, 1, 3, 0x11, 1]))
    for tc_th, (counts, symbols) in ((0x00, DC_LUMA), (0x10, AC_LUMA),
                                     (0x01, DC_CHROMA), (0x11, AC_CHROMA)):
        out += seg(0xC4, bytes([tc_th]) + bytes(counts) + bytes(symbols))
    return out + seg(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))


def mcu_height(sampling: str) -> int:
    return 16 if sampling == "420" else 8


def last_dcs(rgb_above: np.ndarray | None, quality: int, sampling: str,
             precision: str = "islow") -> tuple[int, int, int]:
    """DC predictors after the MCU row ``rgb_above`` (padded, one MCU row
    tall): the DC of each component's last block. (0, 0, 0) at the top."""
    if rgb_above is None:
        return (0, 0, 0)
    m = mcu_height(sampling)
    blocks, comp = mcu_blocks(rgb_above[:, -m:], quality, sampling, precision)
    return tuple(int(blocks[np.flatnonzero(comp == c)[-1], 0]) for c in range(3))


def encode_rows(rgb: np.ndarray, quality: int, sampling: str, prev_dc=(0, 0, 0),
                precision: str = "islow", rows_per_step: int = 64) -> tuple[np.ndarray, int]:
    """Entropy-coded bits of whole MCU rows of a padded image, in steps of
    ``rows_per_step`` MCU rows to bound memory: (bytes, bit count)."""
    m = mcu_height(sampling)
    parts = []
    dcs = tuple(prev_dc)
    step = rows_per_step * m
    for r0 in range(0, rgb.shape[0], step):
        blocks, comp = mcu_blocks(rgb[r0: r0 + step], quality, sampling, precision)
        parts.append(pack_bits(*entropy_words(blocks, comp, dcs)))
        dcs = tuple(int(blocks[np.flatnonzero(comp == c)[-1], 0]) for c in range(3))
    return join_bits(parts)


def encode(rgba: np.ndarray, quality: int, sampling: str = "444",
           precision: str = "islow") -> bytes:
    """A whole baseline JPEG of an (H, W, >=3) uint8 image."""
    h, w = rgba.shape[:2]
    m = mcu_height(sampling)
    rgb = pad_to(np.ascontiguousarray(rgba[..., :3]), m, m)
    scan = finish_scan(*encode_rows(rgb, quality, sampling, precision=precision))
    return header(w, h, quality, sampling) + scan + b"\xff\xd9"
