"""PNG chunk construction and serialization.

Counterpart of the reference's ``src/png-writer.ts``: ``create_chunk`` (CRC
over type+data, png-writer.ts:12-32), ``serialize_chunk`` (len+type+data+crc,
:35-58), ``create_ihdr`` (:61-75), ``create_iend`` (:78-82) and ``build_png``
(:85-107).
"""

from __future__ import annotations

from ...types import PngChunk, PngHeader
from ...utils import PNG_SIGNATURE, png_crc32, write_u32be


def create_chunk(chunk_type: str, data: bytes = b"") -> PngChunk:
    type_bytes = chunk_type.encode("ascii")
    if len(type_bytes) != 4:
        raise ValueError(f"Chunk type must be 4 ASCII chars, got '{chunk_type}'")
    crc = png_crc32(data, png_crc32(type_bytes))
    return PngChunk(length=len(data), type=chunk_type, data=bytes(data), crc=crc)


def serialize_chunk(chunk: PngChunk) -> bytes:
    return (
        write_u32be(chunk.length)
        + chunk.type.encode("ascii")
        + chunk.data
        + write_u32be(chunk.crc)
    )


def create_ihdr(header: PngHeader) -> PngChunk:
    data = (
        write_u32be(header.width)
        + write_u32be(header.height)
        + bytes(
            [
                header.bit_depth,
                header.color_type,
                header.compression_method,
                header.filter_method,
                header.interlace_method,
            ]
        )
    )
    return create_chunk("IHDR", data)


def create_iend() -> PngChunk:
    return create_chunk("IEND")


def create_idat(data: bytes) -> PngChunk:
    return create_chunk("IDAT", data)


def build_png(header: PngHeader, compressed_data: bytes) -> bytes:
    """Assemble a complete single-IDAT PNG (reference: png-writer.ts:85-107)."""
    return (
        PNG_SIGNATURE
        + serialize_chunk(create_ihdr(header))
        + serialize_chunk(create_idat(compressed_data))
        + serialize_chunk(create_iend())
    )
