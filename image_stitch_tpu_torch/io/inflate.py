"""Incremental zlib inflate for streaming PNG decode.

Counterpart of ``createDecompressionStream`` (reference:
src/streaming-inflate.ts:23-76) — feed compressed IDAT fragments in, pull
decompressed bytes out, without materializing the whole stream.

Two tiers, mirroring the reference's native-CompressionStream-vs-pako split
(streaming-inflate.ts:24-26): the owned C++ inflate (native/stitchnative.cpp
owned_inflate — two-level L1-resident tables, 64-bit branchless refills,
~1.5x CPython zlib) when the native library is available, else CPython zlib
(the byte-exact oracle; both produce identical output for valid streams).
The owned tier skips Adler-32 (chunk CRC-32 covers integrity in strict
mode).
"""

from __future__ import annotations

import zlib

from ..errors import StitchError


class StreamingInflator:
    """Push compressed chunks, read decompressed output incrementally.

    ``strict=True`` verifies Adler-32 — used by the PNG decoder's
    verify_crc mode for full integrity checking. The owned native tier
    handles strict mode too (it parses the trailer and checks it against a
    zlib.adler32 accumulation of the output); this class's own body is the
    zlib fallback tier.
    """

    def __new__(cls, strict: bool = False):
        if cls is StreamingInflator:
            try:
                from ..native import NativeInflater, native_available

                if native_available():
                    return NativeInflater(strict=strict)
            except Exception:
                pass
        return super().__new__(cls)

    def __init__(self, strict: bool = False) -> None:
        self._obj = zlib.decompressobj()
        self._finished = False

    @property
    def finished(self) -> bool:
        return self._finished

    def push(self, chunk: bytes | memoryview) -> bytes:
        """Feed a compressed fragment; returns any bytes now available."""
        if self._finished:
            if len(chunk):
                raise StitchError("Inflate stream already finished but more data was pushed")
            return b""
        try:
            out = self._obj.decompress(bytes(chunk))
        except zlib.error as exc:
            raise StitchError("Invalid zlib stream", exc) from exc
        if self._obj.eof:
            self._finished = True
            if self._obj.unused_data.strip(b"\x00"):
                # Residual non-padding data after stream end (reference guards
                # against this too, png-decoder.ts:222-228).
                raise StitchError(
                    f"Unexpected {len(self._obj.unused_data)} residual bytes after zlib stream end"
                )
        return out

    def finish(self) -> bytes:
        """Signal end of input; returns any final decompressed bytes."""
        if self._finished:
            return b""
        try:
            out = self._obj.flush()
        except zlib.error as exc:
            raise StitchError("Truncated or invalid zlib stream", exc) from exc
        self._finished = True
        return out


def decompress_all(data: bytes | memoryview) -> bytes:
    """Whole-buffer inflate helper (reference: src/png-decompress.ts:12-48)."""
    try:
        return zlib.decompress(bytes(data))
    except zlib.error as exc:
        raise StitchError("Invalid zlib stream", exc) from exc
