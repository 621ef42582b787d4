"""PNG chunk parsing with per-chunk CRC verification.

Counterpart of the reference's ``src/png-parser.ts``: a chunk walker that
verifies CRC32 over type+data for every chunk (reference png-parser.ts:29-64)
and a 13-byte IHDR parser (reference png-parser.ts:86-128). Unlike the
reference this parser also surfaces PLTE and tRNS so paletted images decode
fully (superset — the reference throws on color type 3, pixel-ops.ts:609-610).
"""

from __future__ import annotations

from typing import Iterator

from ...errors import StitchError
from ...types import PngChunk, PngHeader
from ...utils import PNG_SIGNATURE, png_crc32, read_u32be

IHDR_LENGTH = 13


def validate_signature(data: bytes | memoryview) -> None:
    if bytes(data[:8]) != PNG_SIGNATURE:
        raise StitchError("Invalid PNG signature")


def read_chunk(data: bytes | memoryview, offset: int, verify_crc: bool = True) -> tuple[PngChunk, int]:
    """Read one chunk at ``offset``; returns (chunk, next_offset)."""
    if offset + 8 > len(data):
        raise StitchError(f"Truncated PNG: chunk header at offset {offset} is incomplete")
    length = read_u32be(data, offset)
    if length > 0x7FFFFFFF:
        raise StitchError(f"Invalid chunk length {length} at offset {offset}")
    type_bytes = bytes(data[offset + 4 : offset + 8])
    try:
        chunk_type = type_bytes.decode("ascii")
    except UnicodeDecodeError as exc:
        raise StitchError(f"Invalid chunk type at offset {offset}") from exc
    end = offset + 8 + length
    if end + 4 > len(data):
        raise StitchError(
            f"Truncated PNG: chunk '{chunk_type}' data at offset {offset} is incomplete"
        )
    chunk_data = bytes(data[offset + 8 : end])
    crc = read_u32be(data, end)
    if verify_crc:
        computed = png_crc32(chunk_data, png_crc32(type_bytes))
        if computed != crc:
            raise StitchError(
                f"CRC mismatch in chunk '{chunk_type}': expected {crc:#010x}, got {computed:#010x}"
            )
    return PngChunk(length=length, type=chunk_type, data=chunk_data, crc=crc), end + 4


def iter_chunks(data: bytes | memoryview, verify_crc: bool = True) -> Iterator[PngChunk]:
    """Walk all chunks after the signature; stops after IEND."""
    validate_signature(data)
    offset = 8
    while offset < len(data):
        chunk, offset = read_chunk(data, offset, verify_crc=verify_crc)
        yield chunk
        if chunk.type == "IEND":
            return


def parse_header_chunk(chunk_data: bytes) -> PngHeader:
    """Parse the 13-byte IHDR payload (reference: png-parser.ts:86-128)."""
    if len(chunk_data) != IHDR_LENGTH:
        raise StitchError(f"IHDR must be {IHDR_LENGTH} bytes, got {len(chunk_data)}")
    width = read_u32be(chunk_data, 0)
    height = read_u32be(chunk_data, 4)
    bit_depth = chunk_data[8]
    color_type = chunk_data[9]
    compression = chunk_data[10]
    filter_method = chunk_data[11]
    interlace = chunk_data[12]
    if width == 0 or height == 0:
        raise StitchError(f"Invalid PNG dimensions: {width}x{height}")
    # PNG spec (11.2.2): width/height are 4-byte values capped at 2^31-1.
    # Fuzz-found: corrupted IHDRs declaring ~2^32 widths drove multi-hundred
    # GiB band allocations (MemoryError) instead of a clean rejection.
    if width > 0x7FFFFFFF or height > 0x7FFFFFFF:
        raise StitchError(
            f"Invalid PNG dimensions: {width}x{height} exceeds 2^31-1"
        )
    valid_depths = {
        0: {1, 2, 4, 8, 16},
        2: {8, 16},
        3: {1, 2, 4, 8},
        4: {8, 16},
        6: {8, 16},
    }
    if color_type not in valid_depths:
        raise StitchError(f"Invalid PNG color type: {color_type}")
    if bit_depth not in valid_depths[color_type]:
        raise StitchError(
            f"Invalid bit depth {bit_depth} for color type {color_type}"
        )
    if compression != 0:
        raise StitchError(f"Invalid compression method: {compression}")
    if filter_method != 0:
        raise StitchError(f"Invalid filter method: {filter_method}")
    if interlace not in (0, 1):
        raise StitchError(f"Invalid interlace method: {interlace}")
    return PngHeader(
        width=width,
        height=height,
        bit_depth=bit_depth,
        color_type=color_type,
        compression_method=compression,
        filter_method=filter_method,
        interlace_method=interlace,
    )


def parse_png_header(data: bytes | memoryview) -> PngHeader:
    """Parse signature + IHDR from the start of a PNG buffer
    (reference: png-parser.ts:131-137)."""
    validate_signature(data)
    chunk, _ = read_chunk(data, 8)
    if chunk.type != "IHDR":
        raise StitchError(f"First chunk must be IHDR, got '{chunk.type}'")
    return parse_header_chunk(chunk.data)


def parse_png_chunks(data: bytes | memoryview, verify_crc: bool = True) -> list[PngChunk]:
    """Parse all chunks (reference: png-parser.ts:139-142)."""
    return list(iter_chunks(data, verify_crc=verify_crc))


def parse_palette(chunk_data: bytes) -> "list[tuple[int, int, int]]":
    """Parse PLTE into (r, g, b) triples. Superset of the reference."""
    if len(chunk_data) % 3 != 0:
        raise StitchError(f"PLTE length {len(chunk_data)} is not a multiple of 3")
    return [
        (chunk_data[i], chunk_data[i + 1], chunk_data[i + 2])
        for i in range(0, len(chunk_data), 3)
    ]
