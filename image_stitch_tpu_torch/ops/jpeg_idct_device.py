"""JPEG decode pixel math in torch: dezigzag, dequantize, islow IDCT, range
limit, fancy upsampling and fixed-point YCbCr -> RGB, bit-identical to the
host libjpeg-exact tier (``codecs/jpeg/libjpeg_exact.py``).

Counterpart of ``image_stitch_tpu/ops/jpeg_idct_device.py``. These are the
plain versions of two hand kernels (``ops/kernels.py``):

- ``decode_plane`` is ``idct_dequant`` (csrc/idct.cu): one component's
  zigzag-prefix coefficients -> its samples;
- ``window_to_rgba`` is ``ycc_rgba`` (csrc/ycc.cu): the component windows
  -> crop, upsample, colour, RGBA.

The JAX file evaluates the IDCT as two-limb int32 linear maps, because a
TPU has no native int64, and proves them exact up to ``M_SAFE``. torch has
int64 on every device, so the port runs libjpeg's butterflies
(``libjpeg_exact._islow_pass1``/``_islow_pass2``) directly in int64: exact
for every int16 coefficient times every 16-bit quantizer, with no bound.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codecs.jpeg.libjpeg_exact import (
    CONST_BITS,
    FIX_0_298631336,
    FIX_0_390180644,
    FIX_0_541196100,
    FIX_0_765366865,
    FIX_0_899976223,
    FIX_1_175875602,
    FIX_1_501321110,
    FIX_1_847759065,
    FIX_1_961570560,
    FIX_2_053119869,
    FIX_2_562915447,
    FIX_3_072711026,
    PASS1_BITS,
)
from ..codecs.jpeg.tables import ZIGZAG

# --------------------------------------------------------------------------- #
# Dezigzag, dequantize, IDCT, range limit
# --------------------------------------------------------------------------- #


def dezigzag_pad(zz_prefix: torch.Tensor, k: int) -> torch.Tensor:
    """(N, k) zigzag-prefix coefficients -> (N, 64) int64 natural order,
    the positions past k zero."""
    nat = torch.zeros((zz_prefix.shape[0], 64), dtype=torch.int64, device=zz_prefix.device)
    nat[:, torch.as_tensor(np.asarray(ZIGZAG[:k], np.int64), device=zz_prefix.device)] = (
        zz_prefix[:, :k].to(torch.int64))
    return nat


def dequantize(nat: torch.Tensor, q_nat: torch.Tensor) -> torch.Tensor:
    """(N, 64) natural-order coefficients times the (64,) natural-order
    quantization table, in int64."""
    return nat.to(torch.int64) * q_nat.to(torch.int64)


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x + (1 << (n - 1))) >> n


def _islow_pass(i: list[torch.Tensor], n: int) -> list[torch.Tensor]:
    """One 8-point pass of jidctint.c's butterfly over 8 int64 tensors
    (``libjpeg_exact._islow_pass1`` and ``_islow_pass2`` share it); returns
    the 8 outputs descaled by ``n`` bits."""
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
    return [_descale(v, n) for v in (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                                      tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def idct_islow(coefq: torch.Tensor) -> torch.Tensor:
    """jpeg_idct_islow over (N, 8, 8) dequantized natural-order blocks
    [row, col]: the column pass, then the row pass, in int64. Returns the
    (N, 8, 8) int64 values before the range limit. libjpeg's shortcut for a
    column whose AC terms are all zero gives dc << PASS1_BITS, which is what
    the general path gives, so there is no shortcut here."""
    x = coefq.to(torch.int64)
    ws = torch.stack(_islow_pass([x[:, r, :] for r in range(8)], CONST_BITS - PASS1_BITS), dim=1)
    return torch.stack(_islow_pass([ws[:, :, c] for c in range(8)],
                                   CONST_BITS + PASS1_BITS + 3), dim=2)


def range_limit(out: torch.Tensor) -> torch.Tensor:
    """jdmaster.c's post-IDCT range limit, ``POST[x & 1023]``: a wrap, not a
    clamp, in closed form (x & 1023 below 128 -> +128; below 512 -> 255;
    below 896 -> 0; else -896)."""
    j = out & 1023
    return torch.where(
        j < 128, j + 128,
        torch.where(j < 512, 255, torch.where(j < 896, 0, j - 896)),
    ).to(torch.uint8)


def decode_plane(zz_prefix: torch.Tensor, q_nat: torch.Tensor, bx: int) -> torch.Tensor:
    """(by * bx, k) zigzag-prefix quantized coefficients of whole block rows
    and the (64,) natural-order table -> the (by * 8, bx * 8) uint8 samples.
    The plain version of ``kernels.idct_dequant``."""
    n, k = zz_prefix.shape
    by = n // bx
    coefq = dequantize(dezigzag_pad(zz_prefix, k), q_nat).reshape(n, 8, 8)
    pix = range_limit(idct_islow(coefq))
    return pix.reshape(by, bx, 8, 8).permute(0, 2, 1, 3).reshape(by * 8, bx * 8)


# --------------------------------------------------------------------------- #
# Upsampling (jdsample.c fancy filters) and colour
# --------------------------------------------------------------------------- #


def _interleave_cols(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    return torch.stack([even, odd], dim=2).reshape(even.shape[0], -1)


def h2v1_fancy_upsample_x(plane: torch.Tensor) -> torch.Tensor:
    """libjpeg_exact.h2v1_fancy_upsample: the triangular filter across, the
    edge columns replicating the edge sample."""
    p = plane.to(torch.int32)
    left = torch.cat([p[:, :1], p[:, :-1]], dim=1)
    right = torch.cat([p[:, 1:], p[:, -1:]], dim=1)
    out = _interleave_cols((p * 3 + left + 1) >> 2, (p * 3 + right + 2) >> 2)
    out = torch.cat([p[:, :1], out[:, 1:-1], p[:, -1:]], dim=1)
    return out.to(torch.uint8)


def h2v2_fancy_upsample_x(plane: torch.Tensor) -> torch.Tensor:
    """libjpeg_exact.h2v2_fancy_upsample: column sums 3 * near + far, then
    the triangular filter across with +8 and +7; the first and last columns
    are (4 * colsum + 8) >> 4 and (4 * colsum + 7) >> 4."""
    p = plane.to(torch.int32)
    h, w = p.shape
    up = torch.cat([p[:1], p[:-1]], dim=0)
    down = torch.cat([p[1:], p[-1:]], dim=0)
    rows = []
    for adj in (up, down):
        colsum = p * 3 + adj
        left = torch.cat([colsum[:, :1], colsum[:, :-1]], dim=1)
        right = torch.cat([colsum[:, 1:], colsum[:, -1:]], dim=1)
        row = _interleave_cols((colsum * 3 + left + 8) >> 4, (colsum * 3 + right + 7) >> 4)
        first = (colsum[:, :1] * 4 + 8) >> 4
        last = (colsum[:, -1:] * 4 + 7) >> 4
        rows.append(torch.cat([first, row[:, 1:-1], last], dim=1))
    return torch.stack(rows, dim=1).reshape(h * 2, w * 2).to(torch.uint8)


def int_upsample_x(plane: torch.Tensor, v: int, h: int) -> torch.Tensor:
    """jdsample.c int_upsample: each sample repeated v times down, h
    across."""
    return plane.repeat_interleave(v, dim=0).repeat_interleave(h, dim=1)


def upsample_plane_x(plane: torch.Tensor, h_expand: int, v_expand: int) -> torch.Tensor:
    """The upsampler libjpeg_exact.upsample_plane selects: fancy only for
    h2v1 and h2v2 and only when the plane is more than 2 samples wide."""
    if h_expand == 1 and v_expand == 1:
        return plane
    if h_expand == 2 and v_expand == 1 and plane.shape[1] > 2:
        return h2v1_fancy_upsample_x(plane)
    if h_expand == 2 and v_expand == 2 and plane.shape[1] > 2:
        return h2v2_fancy_upsample_x(plane)
    return int_upsample_x(plane, v_expand, h_expand)


_SCALEBITS = 16
_ONE_HALF = 1 << (_SCALEBITS - 1)


def _fix(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


# jdcolor.c's constants (build_ycc_rgb_table): every product is below
# 116130 * 128 < 2^24, so int32 holds them.
CR_R = _fix(1.40200)
CB_B = _fix(1.77200)
CB_G = -_fix(0.34414)
CR_G = -_fix(0.71414)


def ycc_to_rgb_planes_x(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor):
    """jdcolor.c's fixed-point YCbCr -> RGB in closed form (the host tier's
    tables hold the same expressions), clipped to 0..255. Returns three
    uint8 planes."""
    yi = y.to(torch.int32)
    cbi = cb.to(torch.int32) - 128
    cri = cr.to(torch.int32) - 128
    r = yi + ((CR_R * cri + _ONE_HALF) >> _SCALEBITS)
    b = yi + ((CB_B * cbi + _ONE_HALF) >> _SCALEBITS)
    g = yi + ((CB_G * cbi + _ONE_HALF + CR_G * cri) >> _SCALEBITS)
    return tuple(c.clamp(0, 255).to(torch.uint8) for c in (r, g, b))


def window_to_rgba(planes, geoms, band_h: int, width: int) -> torch.Tensor:
    """The band's component windows -> (band_h, width, 4) uint8 RGBA, alpha
    255. ``planes``: one (gray) or three uint8 planes as ``decode_plane``
    gives them; ``geoms``: per plane (h_exp, v_exp, r0, w0l, w1l, comp_w):
    the window is rows [w0l, w1l) and columns [0, comp_w) of the plane,
    upsampled, and image row y0 is its upsampled row r0. The plain version
    of ``kernels.ycc_rgba``."""
    out = []
    for plane, (h_exp, v_exp, r0, w0l, w1l, comp_w) in zip(planes, geoms):
        up = upsample_plane_x(plane[w0l:w1l, :comp_w], h_exp, v_exp)
        out.append(up[r0 : r0 + band_h, :width])
    rgb = [out[0]] * 3 if len(out) == 1 else list(ycc_to_rgb_planes_x(*out))
    alpha = torch.full_like(rgb[0], 255)
    return torch.stack(rgb + [alpha], dim=-1)
