"""Legacy-named PNG input adapters and parser class.

The reference keeps a pre-multiformat API surface for compatibility
(src/png-input-adapter.ts:165,347,453 — ``PngInputAdapter``,
``FileInputAdapter``, ``Uint8ArrayInputAdapter`` — and the ``PngParser``
class, src/png-parser.ts:12). Here they are thin, fully functional wrappers
over the band-streaming :class:`PngDecoder` and the chunk-walk functions, so
code written against the reference's names ports mechanically.
"""

from __future__ import annotations

from typing import Iterator

from ...types import PngChunk, PngHeader
from .decoder import PngDecoder
from .parser import iter_chunks, parse_png_header, read_chunk, validate_signature


class PngParser:
    """Chunk walker with CRC verification (reference: PngParser,
    png-parser.ts:12-128)."""

    def __init__(self, data: bytes, verify_crc: bool = True):
        self._data = bytes(data)
        self._verify = verify_crc
        validate_signature(self._data)
        self._offset = 8

    def read_chunk(self) -> PngChunk | None:
        if self._offset >= len(self._data):
            return None
        chunk, self._offset = read_chunk(self._data, self._offset, self._verify)
        return chunk

    def chunks(self) -> Iterator[PngChunk]:
        return iter_chunks(self._data, verify_crc=self._verify)

    def parse_header(self) -> PngHeader:
        return parse_png_header(self._data)


class PngInputAdapter(PngDecoder):
    """Generic PNG input adapter (reference: PngInputAdapter,
    png-input-adapter.ts:165)."""


class FileInputAdapter(PngDecoder):
    """Streams a PNG from a file path without loading it fully
    (reference: FileInputAdapter, png-input-adapter.ts:347)."""

    def __init__(self, path, band_height: int | None = None):
        super().__init__(str(path), band_height=band_height)


class Uint8ArrayInputAdapter(PngDecoder):
    """Decodes a PNG byte buffer (reference: Uint8ArrayInputAdapter,
    png-input-adapter.ts:453)."""

    def __init__(self, data, band_height: int | None = None):
        super().__init__(bytes(data), band_height=band_height)


def create_input_adapter(source, band_height: int | None = None) -> PngDecoder:
    """Factory (reference: createInputAdapter, png-input-adapter.ts:576)."""
    return PngDecoder(source, band_height=band_height)
