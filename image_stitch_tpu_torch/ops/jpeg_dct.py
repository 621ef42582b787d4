"""Exact integer JPEG forward DCT and quantization in torch.

Port of ``image_stitch_tpu/ops/jpeg_dct.py`` (the ``xp``-generic version
that every tier of the JAX package shares): integer YCbCr in 16-bit fixed
point, level shift, two int32 butterfly passes (CONST_BITS 13, PASS1_BITS
2) and quantization by round-half-away, sign * floor((|c| + 4q) / (8q)).
The division is an exact int64 floor (``torch.div(..., rounding_mode=
"floor")``); the TPU needed an f32 divide plus a correction step, which
this port does not copy. Every step is integer arithmetic, so the blocks
equal the JAX package's bit for bit on any device.
"""

from __future__ import annotations

import torch

CONST_BITS = 13
PASS1_BITS = 2

# 13-bit fixed-point DCT constants (round(c * 8192); T.81 §A.3.3 / jfdctint).
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


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x + (1 << (n - 1))) >> n


def _fdct_pass(d, final: bool):
    """One 8-point butterfly pass over 8 parallel int32 tensors (row pass
    with ``final=False``, column pass with ``final=True``)."""
    d0, d1, d2, d3, d4, d5, d6, d7 = d
    t0, t7 = d0 + d7, d0 - d7
    t1, t6 = d1 + d6, d1 - d6
    t2, t5 = d2 + d5, d2 - d5
    t3, t4 = d3 + d4, d3 - d4

    t10, t13 = t0 + t3, t0 - t3
    t11, t12 = t1 + t2, t1 - t2

    if final:
        o0 = _descale(t10 + t11, PASS1_BITS)
        o4 = _descale(t10 - t11, PASS1_BITS)
        shift = CONST_BITS + PASS1_BITS
    else:
        o0 = (t10 + t11) << PASS1_BITS
        o4 = (t10 - t11) << PASS1_BITS
        shift = CONST_BITS - PASS1_BITS

    z1 = (t12 + t13) * FIX_0_541196100
    o2 = _descale(z1 + t13 * FIX_0_765366865, shift)
    o6 = _descale(z1 - t12 * FIX_1_847759065, shift)

    z1 = t4 + t7
    z2 = t5 + t6
    z3 = t4 + t6
    z4 = t5 + t7
    z5 = (z3 + z4) * FIX_1_175875602

    t4 = t4 * FIX_0_298631336
    t5 = t5 * FIX_2_053119869
    t6 = t6 * FIX_3_072711026
    t7 = t7 * FIX_1_501321110
    z1 = z1 * (-FIX_0_899976223)
    z2 = z2 * (-FIX_2_562915447)
    z3 = z3 * (-FIX_1_961570560) + z5
    z4 = z4 * (-FIX_0_390180644) + z5

    o7 = _descale(t4 + z1 + z3, shift)
    o5 = _descale(t5 + z2 + z4, shift)
    o3 = _descale(t6 + z2 + z3, shift)
    o1 = _descale(t7 + z1 + z4, shift)
    return o0, o1, o2, o3, o4, o5, o6, o7


def fdct8_islow_plane(plane: torch.Tensor) -> torch.Tensor:
    """(H, W) int32 level-shifted samples -> (H, W) int32 coefficients
    scaled x8, laid out per block (out[8i+u, 8j+v] = coef (u, v) of block
    (i, j)). H % 8 == 0 and W % 8 == 0."""
    h, w = plane.shape
    r = _fdct_pass([plane[:, i::8] for i in range(8)], final=False)
    inter = torch.stack(r, dim=2).reshape(h, w)
    o = _fdct_pass([inter[i::8, :] for i in range(8)], final=True)
    return torch.stack(o, dim=1).reshape(h, w)


def ycbcr_int(band_rgba: torch.Tensor):
    """(H, W, >=3) uint8 -> three (H, W) int32 planes of integer YCbCr.
    Y lies in [0, 255]; Cb and Cr reach 256 on saturated input (pure blue
    gives Cb = 256) and are not clamped."""
    r = band_rgba[:, :, 0].to(torch.int32)
    g = band_rgba[:, :, 1].to(torch.int32)
    b = band_rgba[:, :, 2].to(torch.int32)
    half = 1 << 15
    y = (19595 * r + 38470 * g + 7471 * b + half) >> 16
    cb = ((-11059) * r + (-21709) * g + 32768 * b + half + (128 << 16)) >> 16
    cr = (32768 * r + (-27439) * g + (-5329) * b + half + (128 << 16)) >> 16
    return y, cb, cr


def quantize_islow(coefs8: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Round-half-away of (c/8)/q as sign * floor((|c| + 4q) / (8q)), with
    an exact int64 floor division. coefs8 and q broadcast; int32 out."""
    mag = coefs8.abs().to(torch.int64)
    q = q.to(torch.int64)
    quot = torch.div(mag + 4 * q, 8 * q, rounding_mode="floor").to(torch.int32)
    return torch.where(coefs8 < 0, -quot, quot)


def _quant_plane(plane: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(H, W) int32 samples -> (H/8, W/8, 64) int32 quantized blocks in
    natural order."""
    hh, ww = plane.shape
    coefs = fdct8_islow_plane(plane - 128)
    quant = quantize_islow(coefs, q.reshape(8, 8).repeat(hh // 8, ww // 8))
    return (
        quant.reshape(hh // 8, 8, ww // 8, 8)
        .permute(0, 2, 1, 3)
        .reshape(hh // 8, ww // 8, 64)
    )


def band_to_blocks_islow(band_rgba: torch.Tensor, luma_q: torch.Tensor,
                         chroma_q: torch.Tensor):
    """(8k, W, >=3) uint8 -> three (k*W/8, 64) int16 quantized
    natural-order blocks in strip-major order. 4:4:4."""
    y, cb, cr = ycbcr_int(band_rgba)
    return tuple(
        _quant_plane(plane, q).reshape(-1, 64).to(torch.int16)
        for plane, q in ((y, luma_q), (cb, chroma_q), (cr, chroma_q))
    )


def band_to_blocks_islow_420(band_rgba: torch.Tensor, luma_q: torch.Tensor,
                             chroma_q: torch.Tensor):
    """4:2:0: full-resolution Y and 2x2 box-averaged chroma ((sum + 2) >> 2).

    band: (16k, W, >=3) uint8, W % 16 == 0. Returns (y (4n, 64) in MCU
    order [TL, TR, BL, BR], cb (n, 64), cr (n, 64)), n MCUs raster-major."""
    h, w = band_rgba.shape[:2]
    y, cb, cr = ycbcr_int(band_rgba)
    yq = (
        _quant_plane(y, luma_q)
        .reshape(h // 16, 2, w // 16, 2, 64)
        .permute(0, 2, 1, 3, 4)
        .reshape(-1, 64)
        .to(torch.int16)
    )

    def subsample(c):
        return (c.reshape(h // 2, 2, w // 2, 2).sum(dim=(1, 3), dtype=torch.int32) + 2) >> 2

    cbq = _quant_plane(subsample(cb), chroma_q).reshape(-1, 64).to(torch.int16)
    crq = _quant_plane(subsample(cr), chroma_q).reshape(-1, 64).to(torch.int16)
    return yq, cbq, crq
