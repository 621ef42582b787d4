"""Whole-buffer PNG (de)compression helpers.

Counterpart of the reference's ``src/png-decompress.ts``: batch-mode
``decompress_data`` (:12-48), ``compress_data`` (:51-75),
``decompress_image_data`` (IDAT concat -> inflate -> Adam7 or row defilter,
:78-135), ``compress_image_data`` (filter rows -> deflate, :138-167) and
``extract_pixel_data`` (:170-176). Used by fixtures and the batch API, not
the streaming hot path.
"""

from __future__ import annotations

import zlib

import numpy as np

from ...errors import StitchError
from ...types import PngHeader
from ...utils import scanline_byte_length, get_bytes_per_pixel
from ...ops.adam7 import deinterlace_adam7, has_adam7_passes
from ...ops.png_filter import defilter_band, filter_select_band
from .parser import iter_chunks, parse_png_header


def decompress_data(data: bytes) -> bytes:
    """Inflate a raw zlib buffer (reference: decompressData)."""
    try:
        return zlib.decompress(bytes(data))
    except zlib.error as exc:
        raise StitchError("Invalid zlib stream", exc) from exc


def compress_data(data: bytes, level: int = 6, filtered: bool = False) -> bytes:
    """Deflate a raw buffer (reference: compressData). Routes through the
    owned C++ deflate when the native tier is available (same wire format,
    ~1.8-2.5x zlib at comparable ratio); zlib otherwise. ``filtered``
    selects the filtered-scanline matcher profile (callers compressing
    filter residuals — see io/deflate.py)."""
    if 1 <= level <= 9:
        from ...native import native_deflater_available

        if native_deflater_available():
            from ...native import NativeDeflator

            d = NativeDeflator(level, filtered=filtered)
            d.compress(data)
            return d.finish()
    return zlib.compress(bytes(data), level)


def decompress_image_data(png_data: bytes) -> tuple[PngHeader, np.ndarray]:
    """Full decode of a PNG buffer to raw (defiltered) scanlines:
    concatenated IDAT -> inflate -> Adam7 deinterlace or band defilter
    (reference: decompressImageData, png-decompress.ts:78-135).

    Returns (header, (height, scanline_bytes) uint8).
    """
    header = parse_png_header(png_data)
    idat = b"".join(c.data for c in iter_chunks(png_data) if c.type == "IDAT")
    if not idat:
        raise StitchError("PNG has no IDAT data")
    raw = decompress_data(idat)
    if has_adam7_passes(header):
        return header, deinterlace_adam7(raw, header)
    row_bytes = scanline_byte_length(header.width, header.bit_depth, header.color_type)
    unit = 1 + row_bytes
    if len(raw) < header.height * unit:
        raise StitchError(
            f"Decompressed data too short: {len(raw)} < {header.height * unit}"
        )
    block = np.frombuffer(raw[: header.height * unit], dtype=np.uint8).reshape(
        header.height, unit
    )
    bpp = get_bytes_per_pixel(header.bit_depth, header.color_type)
    return header, defilter_band(block[:, 0], block[:, 1:], None, bpp)


def compress_image_data(
    pixel_rows: np.ndarray, header: PngHeader, level: int = 6
) -> bytes:
    """Filter every row (best-of-5 heuristic) and deflate
    (reference: compressImageData, png-decompress.ts:138-167)."""
    rows = np.atleast_2d(np.asarray(pixel_rows, dtype=np.uint8))
    bpp = get_bytes_per_pixel(header.bit_depth, header.color_type)
    types, filtered = filter_select_band(rows, None, bpp)
    payload = np.empty((rows.shape[0], 1 + rows.shape[1]), dtype=np.uint8)
    payload[:, 0] = types
    payload[:, 1:] = filtered
    return compress_data(payload.tobytes(), level, filtered=True)


def extract_pixel_data(png_data: bytes) -> np.ndarray:
    """Raw scanlines of a PNG buffer (reference: extractPixelData)."""
    _header, rows = decompress_image_data(png_data)
    return rows
