"""Byte-level utilities shared by the codec layers.

TPU-native counterpart of the reference's ``src/utils.ts``: CRC32 (via the C
zlib already linked into CPython — identical polynomial 0xEDB88320,
reference src/utils.ts:4-29), big-endian u32 I/O, the PNG signature, and
per-color-type sample counts.
"""

from __future__ import annotations

import zlib

import numpy as np

# PNG file signature (reference: src/utils.ts:76).
PNG_SIGNATURE = bytes([0x89, 0x50, 0x4E, 0x47, 0x0D, 0x0A, 0x1A, 0x0A])


def png_crc32(data: bytes | bytearray | memoryview | np.ndarray, initial: int = 0) -> int:
    """CRC32 over ``data`` with the PNG polynomial (reference: src/utils.ts:18-29).

    ``initial`` is a previously returned CRC to continue from (already
    post-conditioned; zlib handles the ~ internally).
    """
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data)
    # zlib.crc32 takes any buffer-protocol object: no bytes() copy (the
    # copy was ~1-2% of strict-mode decode on buffer inputs).
    return zlib.crc32(data, initial) & 0xFFFFFFFF


def read_u32be(data: bytes | memoryview | np.ndarray, offset: int = 0) -> int:
    """Read a big-endian uint32 (reference: src/utils.ts:32-41)."""
    if isinstance(data, np.ndarray):
        data = data.tobytes()
    b = bytes(data[offset : offset + 4])
    if len(b) < 4:
        raise ValueError(f"need 4 bytes at offset {offset}, have {len(b)}")
    return int.from_bytes(b, "big")


def write_u32be(value: int) -> bytes:
    """Serialize a uint32 big-endian (reference: src/utils.ts:44-51)."""
    return int(value & 0xFFFFFFFF).to_bytes(4, "big")


def is_png_signature(data: bytes | memoryview | np.ndarray) -> bool:
    """True if ``data`` starts with the PNG signature (reference:
    isPngSignature, src/utils.ts:83-89)."""
    if isinstance(data, np.ndarray):
        data = data.tobytes()
    return bytes(data[:8]) == PNG_SIGNATURE


def get_samples_per_pixel(color_type: int) -> int:
    """Samples per pixel for a PNG color type (reference: src/utils.ts:92-104)."""
    table = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
    if color_type not in table:
        raise ValueError(f"Unknown color type: {color_type}")
    return table[color_type]


def get_bytes_per_pixel(bit_depth: int, color_type: int) -> int:
    """Ceil bytes per pixel (reference: src/png-filter.ts:186-211)."""
    samples = get_samples_per_pixel(color_type)
    return -(-(samples * bit_depth) // 8)


def scanline_byte_length(width: int, bit_depth: int, color_type: int) -> int:
    """Raw (unfiltered) byte length of one scanline."""
    samples = get_samples_per_pixel(color_type)
    return -(-(width * bit_depth * samples) // 8)


_LIBC = None
_LIBC_TRIED = False


def trim_malloc() -> None:
    """Return freed heap pages to the OS (glibc malloc_trim).

    The band pipeline churns 100s of KB of short-lived buffers per input;
    glibc's dynamic mmap threshold keeps those freed chunks on the heap and
    RSS ratchets to the high-water mark. A periodic trim keeps resident
    memory at the true live set — part of the O(canvas_width) contract the
    memory suite enforces. No-op on non-glibc platforms."""
    global _LIBC, _LIBC_TRIED
    if not _LIBC_TRIED:
        _LIBC_TRIED = True
        try:
            import ctypes

            _LIBC = ctypes.CDLL("libc.so.6")
        except Exception:
            _LIBC = None
    if _LIBC is not None:
        try:
            _LIBC.malloc_trim(0)
        except Exception:
            pass
