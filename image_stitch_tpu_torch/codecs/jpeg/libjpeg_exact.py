"""libjpeg-exact decode backend: integer islow IDCT, range-limit table,
fancy upsampling, and fixed-point YCbCr->RGB — vectorized with numpy.

The owned decoder's job is to be a drop-in for the PIL/libjpeg tier
(reference parity: jpeg-decoder.ts:250-262 falls back from sharp to jpeg-js;
our contract is stronger — bit-identical pixels to libjpeg for every valid
stream, baseline and progressive, at any sampling). That requires
reproducing libjpeg's exact integer arithmetic:

- jidctint.c ``jpeg_idct_islow``: Loeffler-Ligtenberg-Moshovitz 8x8 integer
  IDCT, CONST_BITS=13 / PASS1_BITS=2 fixed point.
- jdmaster.c ``prepare_range_limit_table``: the post-IDCT wraparound clamp.
- jdsample.c ``h2v1_fancy_upsample`` / ``h2v2_fancy_upsample``: triangular
  filters used for 4:2:2 / 4:2:0 chroma (libjpeg default fancy=TRUE);
  ``int_upsample`` replication for other ratios.
- jdcolor.c ``build_ycc_rgb_table``: SCALEBITS=16 fixed-point color convert.

All loops are over the 8 rows/columns of a block (vectorized across every
block of the image at once) or over upsample phases — no per-pixel Python.
"""

from __future__ import annotations

import numpy as np

CONST_BITS = 13
PASS1_BITS = 2

FIX_0_298631336 = 2446
FIX_0_390180644 = 3196
FIX_0_541196100 = 4433
FIX_0_765366865 = 6270
FIX_0_899976223 = 7373
FIX_1_175875602 = 9633
FIX_1_501321110 = 12299
FIX_1_847759065 = 15137
FIX_1_961570560 = 16069
FIX_2_053119869 = 16819
FIX_2_562915447 = 20995
FIX_3_072711026 = 25172

MAXJSAMPLE = 255
CENTERJSAMPLE = 128
RANGE_MASK = MAXJSAMPLE * 4 + 3  # 1023


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    """libjpeg DESCALE: round-to-nearest arithmetic right shift."""
    return (x + (1 << (n - 1))) >> n


def _sample_range_limit() -> np.ndarray:
    """jdmaster.c prepare_range_limit_table — the base (color-convert) table
    with index range [-256, 4*256+128). Returned as a flat array indexed by
    ``idx + 256``."""
    table = np.zeros(5 * (MAXJSAMPLE + 1) + CENTERJSAMPLE, dtype=np.uint8)
    s = MAXJSAMPLE + 1  # offset of index 0
    table[s : s + MAXJSAMPLE + 1] = np.arange(256, dtype=np.uint8)
    post = s + CENTERJSAMPLE  # where the post-IDCT table starts
    table[post + CENTERJSAMPLE : post + 2 * (MAXJSAMPLE + 1)] = MAXJSAMPLE
    # zeros already in the second half...
    table[post + 4 * (MAXJSAMPLE + 1) - CENTERJSAMPLE : post + 4 * (MAXJSAMPLE + 1)] = (
        np.arange(CENTERJSAMPLE, dtype=np.uint8)
    )
    return table


_RANGE_TABLE = _sample_range_limit()
# Post-IDCT lookup: sample = POST[(descale_result) & RANGE_MASK]
_POST_IDCT = _RANGE_TABLE[MAXJSAMPLE + 1 + CENTERJSAMPLE :]
# Color-convert clamp: sample = CLAMP[y + delta + 256] for y+delta in [-256, 511]
_CC_CLAMP = _RANGE_TABLE


def idct_islow_blocks(coef: np.ndarray) -> np.ndarray:
    """jpeg_idct_islow over (N, 8, 8) dequantized int32 coefficient blocks
    (natural order, [row, col]); returns (N, 8, 8) uint8 samples."""
    ws = _islow_pass1(coef.astype(np.int64))
    out = _islow_pass2(ws)
    return _POST_IDCT[out & RANGE_MASK]


def _islow_pass1(blk: np.ndarray) -> np.ndarray:
    """Column pass: blk (N, 8, 8) [row, col] -> workspace (N, 8, 8) int64.

    Note: libjpeg's AC-terms-all-zero column shortcut produces identical
    values to the general path (dcval << PASS1_BITS == DESCALE of the even
    part alone), so the vectorized general path is exact.
    """
    i = [blk[:, r, :] for r in range(8)]  # i[r]: (N, 8) column vectors

    z2, z3 = i[2], i[6]
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 + z3 * (-FIX_1_847759065)
    tmp3 = z1 + z2 * FIX_0_765366865
    z2, z3 = i[0], i[4]
    tmp0 = (z2 + z3) << CONST_BITS
    tmp1 = (z2 - z3) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    t0, t1, t2, t3 = i[7], i[5], i[3], i[1]
    z1 = t0 + t3
    z2 = t1 + t2
    z3 = t0 + t2
    z4 = t1 + t3
    z5 = (z3 + z4) * FIX_1_175875602
    t0 = t0 * FIX_0_298631336
    t1 = t1 * FIX_2_053119869
    t2 = t2 * FIX_3_072711026
    t3 = t3 * FIX_1_501321110
    z1 = z1 * (-FIX_0_899976223)
    z2 = z2 * (-FIX_2_562915447)
    z3 = z3 * (-FIX_1_961570560) + z5
    z4 = z4 * (-FIX_0_390180644) + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4

    n = CONST_BITS - PASS1_BITS
    ws = np.empty_like(blk)
    ws[:, 0, :] = _descale(tmp10 + t3, n)
    ws[:, 7, :] = _descale(tmp10 - t3, n)
    ws[:, 1, :] = _descale(tmp11 + t2, n)
    ws[:, 6, :] = _descale(tmp11 - t2, n)
    ws[:, 2, :] = _descale(tmp12 + t1, n)
    ws[:, 5, :] = _descale(tmp12 - t1, n)
    ws[:, 3, :] = _descale(tmp13 + t0, n)
    ws[:, 4, :] = _descale(tmp13 - t0, n)
    return ws


def _islow_pass2(ws: np.ndarray) -> np.ndarray:
    """Row pass: workspace (N, 8, 8) -> descaled outputs (N, 8, 8) int64."""
    i = [ws[:, :, c] for c in range(8)]  # i[c]: (N, 8) row vectors

    z2, z3 = i[2], i[6]
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 + z3 * (-FIX_1_847759065)
    tmp3 = z1 + z2 * FIX_0_765366865
    z2, z3 = i[0], i[4]
    tmp0 = (z2 + z3) << CONST_BITS
    tmp1 = (z2 - z3) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    t0, t1, t2, t3 = i[7], i[5], i[3], i[1]
    z1 = t0 + t3
    z2 = t1 + t2
    z3 = t0 + t2
    z4 = t1 + t3
    z5 = (z3 + z4) * FIX_1_175875602
    t0 = t0 * FIX_0_298631336
    t1 = t1 * FIX_2_053119869
    t2 = t2 * FIX_3_072711026
    t3 = t3 * FIX_1_501321110
    z1 = z1 * (-FIX_0_899976223)
    z2 = z2 * (-FIX_2_562915447)
    z3 = z3 * (-FIX_1_961570560) + z5
    z4 = z4 * (-FIX_0_390180644) + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4

    n = CONST_BITS + PASS1_BITS + 3
    out = np.empty_like(ws)
    out[:, :, 0] = _descale(tmp10 + t3, n)
    out[:, :, 7] = _descale(tmp10 - t3, n)
    out[:, :, 1] = _descale(tmp11 + t2, n)
    out[:, :, 6] = _descale(tmp11 - t2, n)
    out[:, :, 2] = _descale(tmp12 + t1, n)
    out[:, :, 5] = _descale(tmp12 - t1, n)
    out[:, :, 3] = _descale(tmp13 + t0, n)
    out[:, :, 4] = _descale(tmp13 - t0, n)
    return out


# --------------------------------------------------------------------------- #
# Upsampling (jdsample.c, do_fancy_upsampling = TRUE default)
# --------------------------------------------------------------------------- #


def h2v1_fancy_upsample(plane: np.ndarray) -> np.ndarray:
    """Horizontal 2x triangular filter (jdsample.c h2v1_fancy_upsample)."""
    h, w = plane.shape
    p = plane.astype(np.int32)
    out = np.empty((h, w * 2), dtype=np.int32)
    left = np.concatenate([p[:, :1], p[:, :-1]], axis=1)
    right = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
    out[:, 0::2] = (p * 3 + left + 1) >> 2
    out[:, 1::2] = (p * 3 + right + 2) >> 2
    # Edge columns: pure replication of the edge sample.
    out[:, 0] = p[:, 0]
    out[:, -1] = p[:, -1]
    return out.astype(np.uint8)


def h2v2_fancy_upsample(plane: np.ndarray) -> np.ndarray:
    """2x2 triangular filter (jdsample.c h2v2_fancy_upsample)."""
    h, w = plane.shape
    p = plane.astype(np.int32)
    up = np.concatenate([p[:1], p[:-1]], axis=0)
    down = np.concatenate([p[1:], p[-1:]], axis=0)
    out = np.empty((h * 2, w * 2), dtype=np.int32)
    for phase, adj in ((0, up), (1, down)):
        colsum = p * 3 + adj  # (h, w)
        left = np.concatenate([colsum[:, :1], colsum[:, :-1]], axis=1)
        right = np.concatenate([colsum[:, 1:], colsum[:, -1:]], axis=1)
        rows = out[phase::2]
        rows[:, 0::2] = (colsum * 3 + left + 8) >> 4
        rows[:, 1::2] = (colsum * 3 + right + 7) >> 4
        rows[:, 0] = (colsum[:, 0] * 4 + 8) >> 4
        rows[:, -1] = (colsum[:, -1] * 4 + 7) >> 4
    return out.astype(np.uint8)


def int_upsample(plane: np.ndarray, v: int, h: int) -> np.ndarray:
    """Replication upsample (jdsample.c int_upsample)."""
    return np.repeat(np.repeat(plane, v, axis=0), h, axis=1)


def upsample_plane(plane: np.ndarray, h_expand: int, v_expand: int) -> np.ndarray:
    """Select the upsampler libjpeg would (jdsample.c jinit_upsampler with
    do_fancy_upsampling=TRUE). The fancy filters are only selected when
    downsampled_width > 2 — narrower planes use plain replication
    (jinit_upsampler's `do_fancy && compptr->downsampled_width > 2`
    condition; session-5 soak found 1-4 px subsampled images decoding
    off-by-rounding without this)."""
    if h_expand == 1 and v_expand == 1:
        return plane
    if h_expand == 2 and v_expand == 1 and plane.shape[1] > 2:
        return h2v1_fancy_upsample(plane)
    if h_expand == 2 and v_expand == 2 and plane.shape[1] > 2:
        return h2v2_fancy_upsample(plane)
    return int_upsample(plane, v_expand, h_expand)


# --------------------------------------------------------------------------- #
# Color conversion (jdcolor.c build_ycc_rgb_table, SCALEBITS = 16)
# --------------------------------------------------------------------------- #

_SCALEBITS = 16
_ONE_HALF = 1 << (_SCALEBITS - 1)


def _fix(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


_I = np.arange(256, dtype=np.int64) - CENTERJSAMPLE
_CR_R = (_fix(1.40200) * _I + _ONE_HALF) >> _SCALEBITS
_CB_B = (_fix(1.77200) * _I + _ONE_HALF) >> _SCALEBITS
_CR_G = -_fix(0.71414) * _I
_CB_G = -_fix(0.34414) * _I + _ONE_HALF


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """Fixed-point YCbCr -> RGB with the libjpeg clamp table; inputs are
    full-resolution uint8 planes."""
    yi = y.astype(np.int64)
    cbi = cb.astype(np.int64)
    cri = cr.astype(np.int64)
    r = _CC_CLAMP[(yi + _CR_R[cri]) + (MAXJSAMPLE + 1)]
    g = _CC_CLAMP[
        (yi + ((_CB_G[cbi] + _CR_G[cri]) >> _SCALEBITS)) + (MAXJSAMPLE + 1)
    ]
    b = _CC_CLAMP[(yi + _CB_B[cbi]) + (MAXJSAMPLE + 1)]
    return np.stack([r, g, b], axis=-1)
