"""Raw pixel-array inputs — the canvas-input analog.

The reference's browser entry accepts HTMLCanvasElements whose pixel
buffers feed the pipeline directly (concatCanvases,
image-concat-browser.ts:287-323). The Python-native equivalent: any
``(H, W, 3|4)`` uint8/uint16 numpy array is a first-class input source —
in grids, positioned mode, or ImageSource factories — with no encode
round-trip.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from ..errors import StitchError
from ..types import DecoderOptions, ImageHeader

DEFAULT_BAND_HEIGHT = 256


def is_pixel_array(source) -> bool:
    return (
        isinstance(source, np.ndarray)
        and source.ndim == 3
        and source.shape[2] in (3, 4)
        and source.dtype in (np.uint8, np.uint16)
    )


class ArrayDecoder:
    """Serves a raw (H, W, 3|4) uint8/uint16 array as a decoder."""

    format = "raw"

    def __init__(self, source: np.ndarray, options: DecoderOptions | None = None):
        if not is_pixel_array(source):
            raise StitchError(
                "Array inputs must be (H, W, 3|4) uint8/uint16, got "
                f"shape {getattr(source, 'shape', None)} dtype "
                f"{getattr(source, 'dtype', None)}"
            )
        h, w, c = source.shape
        if h < 1 or w < 1:
            raise StitchError(f"Array input has empty dimensions: {source.shape}")
        if c == 3:
            rgba = np.empty((h, w, 4), dtype=source.dtype)
            rgba[:, :, :3] = source
            rgba[:, :, 3] = 65535 if source.dtype == np.uint16 else 255
        else:
            rgba = np.ascontiguousarray(source)
        self._rgba = rgba
        self._band_height = (
            (options.band_height if options else None) or DEFAULT_BAND_HEIGHT
        )

    def get_header(self) -> ImageHeader:
        h, w = self._rgba.shape[:2]
        depth = 16 if self._rgba.dtype == np.uint16 else 8
        return ImageHeader(width=w, height=h, channels=4, bit_depth=depth,
                           format="raw")

    def bands(self, band_height: int | None = None) -> Iterator[np.ndarray]:
        band_height = band_height or self._band_height
        h, w = self._rgba.shape[:2]
        if self._rgba.dtype == np.uint16:
            # Raw scanline bytes are big-endian 16-bit (PNG layout, the
            # pipeline's common wire format for 16-bit rows).
            flat = (
                self._rgba.astype(">u2").view(np.uint8).reshape(h, w * 8)
            )
        else:
            flat = self._rgba.reshape(h, w * 4)
        for y0 in range(0, h, band_height):
            yield flat[y0 : y0 + band_height]

    def scanlines(self) -> Iterator[np.ndarray]:
        for band in self.bands():
            yield from band

    def close(self) -> None:
        pass
