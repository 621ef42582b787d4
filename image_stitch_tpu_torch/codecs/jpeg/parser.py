"""JPEG header (SOF) parsing.

Counterpart of the reference's header-only parse (src/jpeg-decoder.ts:46-97):
walks markers to any SOF segment and extracts dimensions/channels without
decoding pixel data. Recognizes the same 13 SOF marker types
(jpeg-decoder.ts:26-40).
"""

from __future__ import annotations

from ...errors import StitchError
from ...types import ImageHeader

# SOF0-SOF15 minus DHT(C4)/JPG(C8)/DAC(CC) (reference: jpeg-decoder.ts:26-40).
SOF_MARKERS = {
    0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7,
    0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF,
}

PROGRESSIVE_MARKERS = {0xC2, 0xC6, 0xCA, 0xCE}


def parse_jpeg_header(data: bytes | memoryview) -> ImageHeader:
    """Parse SOI + marker walk to SOF (reference: parseJpegHeader,
    jpeg-decoder.ts:46-97)."""
    data = bytes(data)
    if len(data) < 4 or data[0] != 0xFF or data[1] != 0xD8:
        raise StitchError("Invalid JPEG: missing SOI marker")
    offset = 2
    while offset + 4 <= len(data):
        if data[offset] != 0xFF:
            offset += 1
            continue
        marker = data[offset + 1]
        if marker == 0xFF:
            offset += 1
            continue
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            offset += 2
            continue
        if offset + 4 > len(data):
            break
        seg_len = (data[offset + 2] << 8) | data[offset + 3]
        if marker in SOF_MARKERS:
            if offset + 2 + seg_len > len(data) or seg_len < 8:
                raise StitchError("Truncated JPEG SOF segment")
            precision = data[offset + 4]
            height = (data[offset + 5] << 8) | data[offset + 6]
            width = (data[offset + 7] << 8) | data[offset + 8]
            channels = data[offset + 9]
            if width == 0 or height == 0:
                raise StitchError(f"Invalid JPEG dimensions: {width}x{height}")
            return ImageHeader(
                width=width,
                height=height,
                channels=channels,
                bit_depth=precision,
                format="jpeg",
                metadata={
                    "progressive": marker in PROGRESSIVE_MARKERS,
                    "sof_marker": marker,
                },
            )
        if marker == 0xD9:  # EOI before SOF
            break
        offset += 2 + seg_len
    raise StitchError("Invalid JPEG: no SOF marker found")
