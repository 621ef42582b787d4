"""Adam7 deinterlacing.

Counterpart of the reference's ``src/adam7.ts``: the 7 standard passes
(adam7.ts:23-31), per-pass defiltering with a pass-local previous row
(adam7.ts:75-92), and a scatter of pass pixels into the final image
(distributePassPixels, adam7.ts:115-155; sub-byte path :158-184). The
reference scatters one pixel at a time in JS; here each pass is defiltered as
a band and scattered with strided array assignment, and sub-byte depths go
through an unpack -> strided scatter -> repack path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..errors import StitchError
from ..types import PngHeader
from ..utils import get_bytes_per_pixel, get_samples_per_pixel, scanline_byte_length
from .png_filter import defilter_band


@dataclass(frozen=True)
class Adam7Pass:
    x_start: int
    y_start: int
    x_step: int
    y_step: int


ADAM7_PASSES: tuple[Adam7Pass, ...] = (
    Adam7Pass(0, 0, 8, 8),
    Adam7Pass(4, 0, 8, 8),
    Adam7Pass(0, 4, 4, 8),
    Adam7Pass(2, 0, 4, 4),
    Adam7Pass(0, 2, 2, 4),
    Adam7Pass(1, 0, 2, 2),
    Adam7Pass(0, 1, 1, 2),
)


def get_pass_dimensions(width: int, height: int, p: Adam7Pass) -> tuple[int, int]:
    """Pass sub-image dimensions (reference: getPassDimensions, adam7.ts:36-44)."""
    pw = -(-(width - p.x_start) // p.x_step) if width > p.x_start else 0
    ph = -(-(height - p.y_start) // p.y_step) if height > p.y_start else 0
    return max(0, pw), max(0, ph)


def has_adam7_passes(header: PngHeader) -> bool:
    """True if interlaced (reference: hasAdam7Passes, adam7.ts:190-198)."""
    return header.interlace_method == 1


def _unpack_row_bits(rows: np.ndarray, width: int, bit_depth: int) -> np.ndarray:
    # Per-depth shift/mask fast paths (MSB-first within each byte, PNG
    # 7.2): the generic unpackbits+weighted-sum form cost a ufunc reduce
    # per call and dominated sub-byte interlaced tiles.
    if bit_depth == 8:
        return rows[:, :width]
    if bit_depth == 4:
        out = np.empty((rows.shape[0], rows.shape[1] * 2), dtype=np.uint8)
        out[:, 0::2] = rows >> 4
        out[:, 1::2] = rows & 0x0F
        return out[:, :width]
    if bit_depth == 2:
        out = np.empty((rows.shape[0], rows.shape[1] * 4), dtype=np.uint8)
        for k in range(4):
            out[:, k::4] = (rows >> (6 - 2 * k)) & 0x03
        return out[:, :width]
    return np.unpackbits(rows, axis=1)[:, :width]  # bit_depth == 1


def _pack_row_bits(values: np.ndarray, bit_depth: int) -> np.ndarray:
    h, w = values.shape
    if bit_depth == 1:
        return np.packbits(values, axis=1)
    per = 8 // bit_depth
    pad = (-w) % per
    if pad:
        values = np.concatenate(
            [values, np.zeros((h, pad), dtype=values.dtype)], axis=1
        )
    out = np.zeros((h, values.shape[1] // per), dtype=np.uint8)
    for k in range(per):
        out |= (values[:, k::per] & ((1 << bit_depth) - 1)).astype(
            np.uint8
        ) << (8 - bit_depth * (k + 1))
    return out


def adam7_payload_length(header: PngHeader) -> int:
    """Exact decompressed IDAT byte count of an interlaced image (the
    pass-concatenated filtered scanlines, adam7.ts:52-112 layout)."""
    total = 0
    for p in ADAM7_PASSES:
        pw, ph = get_pass_dimensions(header.width, header.height, p)
        if pw and ph:
            total += ph * (
                1 + scanline_byte_length(pw, header.bit_depth, header.color_type)
            )
    return total


def deinterlace_adam7_batch(stack: np.ndarray, header: PngHeader) -> np.ndarray:
    """Batched Adam7 deinterlace of n same-format tiles.

    ``stack`` is (n, payload_len) uint8: each row one tile's fully
    inflated interlaced IDAT payload. Returns (n, height, row_bytes) raw
    scanlines, bit-identical per tile to :func:`deinterlace_adam7`
    (tests/unit/test_group_decode.py), but with ONE defilter call and ONE
    strided scatter per PASS for the whole group instead of per tile —
    on 32x32 interlaced tiles the per-tile pass loop is pure fixed cost
    (7 defilter calls + 7 numpy scatters each for a few hundred bytes).

    The zeroed separator row before each tile's pass block reproduces
    prev_row=None filter semantics inside the single stacked defilter,
    same trick as the non-interlaced group decode.
    """
    from ..native import defilter_units_native

    n = int(stack.shape[0])
    bpp = get_bytes_per_pixel(header.bit_depth, header.color_type)
    samples = get_samples_per_pixel(header.color_type)
    row_bytes = scanline_byte_length(header.width, header.bit_depth, header.color_type)
    sub_byte = header.bit_depth < 8
    out = np.zeros((n, header.height, row_bytes), dtype=np.uint8)
    if sub_byte:
        out_vals = np.zeros((n, header.height, header.width), dtype=np.uint8)

    offset = 0
    for p in ADAM7_PASSES:
        pw, ph = get_pass_dimensions(header.width, header.height, p)
        if pw == 0 or ph == 0:
            continue
        prb = scanline_byte_length(pw, header.bit_depth, header.color_type)
        unit = 1 + prb
        need = ph * unit
        if offset + need > stack.shape[1]:
            raise StitchError(
                f"Truncated interlaced data: pass needs {need} bytes, "
                f"have {stack.shape[1] - offset}"
            )
        blocks = stack[:, offset : offset + need].reshape(n, ph, unit)
        offset += need
        sep = np.zeros((n, ph + 1, unit), dtype=np.uint8)
        sep[:, 1:] = blocks
        flat = sep.reshape(n * (ph + 1), unit)
        raw = defilter_units_native(flat, prb, bpp, None)
        if raw is None:
            raw = defilter_band(flat[:, 0], flat[:, 1:], None, bpp)
        raw = raw.reshape(n, ph + 1, prb)[:, 1:]
        ys = slice(p.y_start, p.y_start + ph * p.y_step, p.y_step)
        xs = slice(p.x_start, p.x_start + pw * p.x_step, p.x_step)
        if sub_byte:
            vals = _unpack_row_bits(
                np.ascontiguousarray(raw.reshape(n * ph, prb)), pw,
                header.bit_depth,
            ).reshape(n, ph, pw)
            out_vals[:, ys, xs] = vals
        else:
            bytes_per = samples * (2 if header.bit_depth == 16 else 1)
            src = raw[:, :, : pw * bytes_per].reshape(n, ph, pw, bytes_per)
            dst = out[:, ys].reshape(n, ph, header.width, bytes_per)
            dst[:, :, xs] = src
            out[:, ys] = dst.reshape(n, ph, row_bytes)

    if sub_byte:
        packed = _pack_row_bits(
            out_vals.reshape(n * header.height, header.width), header.bit_depth
        )
        out = np.zeros((n * header.height, row_bytes), dtype=np.uint8)
        out[:, : min(row_bytes, packed.shape[1])] = packed[:, :row_bytes]
        out = out.reshape(n, header.height, row_bytes)
    return out


def deinterlace_adam7(decompressed: bytes | np.ndarray, header: PngHeader) -> np.ndarray:
    """Deinterlace the full decompressed IDAT payload into raw (unfiltered)
    scanlines, row-major (reference: deinterlaceAdam7, adam7.ts:52-112).

    Returns (height, scanline_bytes) uint8 in the source pixel format.
    """
    data = np.frombuffer(bytes(decompressed), dtype=np.uint8) if not isinstance(
        decompressed, np.ndarray
    ) else decompressed
    bpp = get_bytes_per_pixel(header.bit_depth, header.color_type)
    samples = get_samples_per_pixel(header.color_type)
    row_bytes = scanline_byte_length(header.width, header.bit_depth, header.color_type)
    out = np.zeros((header.height, row_bytes), dtype=np.uint8)
    sub_byte = header.bit_depth < 8
    if sub_byte:
        out_vals = np.zeros((header.height, header.width), dtype=np.uint8)

    offset = 0
    for p in ADAM7_PASSES:
        pw, ph = get_pass_dimensions(header.width, header.height, p)
        if pw == 0 or ph == 0:
            continue
        pass_row_bytes = scanline_byte_length(pw, header.bit_depth, header.color_type)
        needed = ph * (1 + pass_row_bytes)
        if offset + needed > data.shape[0]:
            raise StitchError(
                f"Truncated interlaced data: pass needs {needed} bytes, "
                f"have {data.shape[0] - offset}"
            )
        block = data[offset : offset + needed].reshape(ph, 1 + pass_row_bytes)
        offset += needed
        # Native SIMD defilter when available (pass defilters dominated
        # small interlaced tiles at ~7 numpy calls each); same kernels and
        # bytes as the streaming decoder's band path.
        from ..native import defilter_units_native

        raw = defilter_units_native(block, pass_row_bytes, bpp, None)
        if raw is None:
            raw = defilter_band(block[:, 0], block[:, 1:], None, bpp)

        ys = slice(p.y_start, p.y_start + ph * p.y_step, p.y_step)
        if sub_byte:
            vals = _unpack_row_bits(raw, pw, header.bit_depth)
            out_vals[ys, p.x_start : p.x_start + pw * p.x_step : p.x_step] = vals
        else:
            # Scatter whole pixels: view pass rows as (ph, pw, bytes/pixel).
            bytes_per = samples * (2 if header.bit_depth == 16 else 1)
            src = raw[:, : pw * bytes_per].reshape(ph, pw, bytes_per)
            dst = out[ys].reshape(ph, header.width, bytes_per)
            dst[:, p.x_start : p.x_start + pw * p.x_step : p.x_step] = src
            out[ys] = dst.reshape(ph, row_bytes)

    if sub_byte:
        out = _pack_row_bits(out_vals, header.bit_depth)
        # Pad/trim to the exact scanline byte length.
        if out.shape[1] != row_bytes:
            fixed = np.zeros((header.height, row_bytes), dtype=np.uint8)
            fixed[:, : min(row_bytes, out.shape[1])] = out[:, :row_bytes]
            out = fixed
    return out
