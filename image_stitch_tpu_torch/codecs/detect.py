"""Magic-byte image format detection.

Counterpart of the reference's ``src/decoders/format-detection.ts``: PNG
8-byte signature (:15-26), JPEG ``FF D8 FF`` (:30), HEIC via the ISO-BMFF
``ftyp`` box with brand + compatible-brand scan (:36-65). ``read_magic_bytes``
reads the first 32 bytes of a path / buffer / stream (:76-114).
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np

from ..errors import StitchError
from ..utils import PNG_SIGNATURE

MAGIC_BYTES_LENGTH = 32

# Path inputs at or below this size are read whole and decoded from the
# buffer path (see read_magic_and_source); larger files stream from the fd.
SMALL_FILE_SLURP_BYTES = 1 << 20

HEIC_BRANDS = {
    # reference: format-detection.ts:44-55
    b"heic", b"heix", b"hevc", b"hevx",
    b"heim", b"heis", b"hevm", b"hevs",
    b"mif1", b"msf1",
}


def detect_image_format(magic: bytes) -> str | None:
    """Return 'png' | 'jpeg' | 'heic' | None from leading bytes
    (reference: detectImageFormat, format-detection.ts:9-73)."""
    if len(magic) >= 8 and magic[:8] == PNG_SIGNATURE:
        return "png"
    if len(magic) >= 3 and magic[0] == 0xFF and magic[1] == 0xD8 and magic[2] == 0xFF:
        return "jpeg"
    if len(magic) >= 12 and magic[4:8] == b"ftyp":
        major = magic[8:12]
        if major in HEIC_BRANDS:
            return "heic"
        # Scan compatible brands in the remainder of what we have.
        for off in range(16, len(magic) - 3, 4):
            if magic[off : off + 4] in HEIC_BRANDS:
                return "heic"
    return None


class PushbackStream:
    """Readable wrapper that re-serves bytes consumed during format
    detection before delegating to the underlying non-seekable stream.
    Decoders in this package only ever ``.read()`` sequentially, so this
    is a complete restoration of the stream state."""

    def __init__(self, head: bytes, stream: Any):
        self._head = head
        self._pos = 0
        self._stream = stream

    def read(self, n: int = -1) -> bytes:
        if self._pos < len(self._head):
            if n is None or n < 0:
                out = self._head[self._pos :] + (self._stream.read(-1) or b"")
                self._pos = len(self._head)
                return out
            out = self._head[self._pos : self._pos + n]
            self._pos += len(out)
            if len(out) < n:
                out += self._stream.read(n - len(out)) or b""
            return bytes(out)
        return self._stream.read(n)

    def close(self) -> None:
        close = getattr(self._stream, "close", None)
        if close is not None:
            close()


def _stream_is_seekable(source: Any) -> bool:
    if not (hasattr(source, "tell") and hasattr(source, "seek")):
        return False
    seekable = getattr(source, "seekable", None)
    if seekable is not None:
        try:
            return bool(seekable())
        except Exception:
            return False
    return True


def read_magic_bytes(source: Any) -> bytes:
    """First 32 bytes of a file path, buffer, or readable stream
    (reference: readMagicBytes, format-detection.ts:76-114).

    Non-seekable streams cannot be restored by this function — use
    ``read_magic_and_source`` (which returns a pushback-wrapped stream)
    when the source will be consumed afterwards."""
    return read_magic_and_source(source)[0]


def read_magic_and_source(source: Any) -> tuple[bytes, Any]:
    """Read the magic bytes and return ``(magic, source)`` where ``source``
    is usable from offset 0: seekable streams are rewound; non-seekable
    streams come back wrapped in :class:`PushbackStream`."""
    if isinstance(source, (bytes, bytearray, memoryview)):
        return bytes(source[:MAGIC_BYTES_LENGTH]), source
    if isinstance(source, np.ndarray):
        return source.tobytes()[:MAGIC_BYTES_LENGTH], source
    if isinstance(source, (str, os.PathLike)):
        try:
            size = os.path.getsize(source)
        except OSError:
            size = -1
        if 0 <= size <= SMALL_FILE_SLURP_BYTES:
            # Slurp small files into one buffer: the chunked file path
            # costs ~20 tiny reads + an extra open per image, which
            # dominates many-small-tile configs (pngsuite: ~12% of the
            # whole pipeline). Pixels are identical either way; large
            # files keep the streaming fd path (O(band) memory).
            with open(source, "rb") as f:
                data = f.read()
            return data[:MAGIC_BYTES_LENGTH], data
        with open(source, "rb") as f:
            return f.read(MAGIC_BYTES_LENGTH), source
    if hasattr(source, "read"):
        if _stream_is_seekable(source):
            pos = source.tell()
            data = source.read(MAGIC_BYTES_LENGTH)
            source.seek(pos)
            return bytes(data or b""), source
        data = bytes(source.read(MAGIC_BYTES_LENGTH) or b"")
        return data, PushbackStream(data, source)
    raise StitchError(f"Cannot read magic bytes from {type(source).__name__}")


def detect_format(source: Any) -> str | None:
    """Detect the format of any supported input source
    (reference: detectFormat, format-detection.ts:122-130)."""
    return detect_image_format(read_magic_bytes(source))


def validate_format(source: Any, expected: str) -> bool:
    """(reference: validateFormat, format-detection.ts:133-137)."""
    return detect_format(source) == expected
