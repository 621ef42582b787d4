"""HEIC decoder plugin (host-side, gated on an available backend).

Counterpart of the reference's ``src/decoders/heic-decoder.ts``. Backend
tiers mirror the reference's sharp → heic-decode/libheif-js ladder
(:266-285): here pillow-heif (libheif) when installed, else a
custom-injected decoder, else a clear error. Decode happens once, then rows
stream out in bands (:362-380).

Superset: the reference has no header-without-decode path (parseHeicHeader
stub, heic-decoder.ts:256-261, so getHeader triggers a FULL decode,
:326-360). Here ``get_header`` parses the ISO-BMFF metadata directly —
``meta`` → ``pitm`` (primary item) → ``iprp``/``ipco``/``ipma`` (property
association) → the primary item's ``ispe`` (spatial extents) and ``irot``
(rotation, which swaps the reported dimensions for 90/270) — so headers
cost a few KB of box walking and need no decode backend at all. The full
decode stays deferred to the first pixel pull; if the box parse fails the
decode-on-header fallback still applies.
"""

from __future__ import annotations

import io
import os
from typing import Iterator

import numpy as np

from ..errors import StitchError
from ..types import DecoderOptions, ImageHeader

DEFAULT_BAND_HEIGHT = 256


def _iter_boxes(data: memoryview, start: int, end: int):
    """Yield (type, body_start, body_end) for ISO-BMFF boxes in [start, end)."""
    pos = start
    while pos + 8 <= end:
        size = int.from_bytes(data[pos : pos + 4], "big")
        btype = bytes(data[pos + 4 : pos + 8])
        header = 8
        if size == 1:  # 64-bit largesize
            if pos + 16 > end:
                return
            size = int.from_bytes(data[pos + 8 : pos + 16], "big")
            header = 16
        elif size == 0:  # to end of enclosing box
            size = end - pos
        if size < header or pos + size > end:
            return
        yield btype, pos + header, pos + size
        pos += size


def _find_box(data: memoryview, start: int, end: int, btype: bytes,
              fullbox: bool = False):
    """First box of ``btype`` in [start, end); returns (body_start, body_end)
    past the version/flags word when ``fullbox``."""
    for t, b0, b1 in _iter_boxes(data, start, end):
        if t == btype:
            return (b0 + 4, b1) if fullbox else (b0, b1)
    return None


def parse_heic_header(data: bytes) -> tuple[int, int] | None:
    """Primary-image (width, height) from the HEIF metadata, or None.

    Walks meta → pitm → iprp{ipco, ipma}, resolves the primary item's
    associated properties, reads its ispe and applies irot (ISO/IEC
    23008-12 §6.5.3, §7.1.3). No decode backend required.
    """
    try:
        mv = memoryview(data)
        meta = _find_box(mv, 0, len(data), b"meta", fullbox=True)
        if meta is None:
            return None
        m0, m1 = meta
        pitm = _find_box(mv, m0, m1, b"pitm")
        primary_id = None
        if pitm is not None:
            version = mv[pitm[0]]
            body = pitm[0] + 4
            if version == 0:
                primary_id = int.from_bytes(mv[body : body + 2], "big")
            else:
                primary_id = int.from_bytes(mv[body : body + 4], "big")
        iprp = _find_box(mv, m0, m1, b"iprp")
        if iprp is None:
            return None
        ipco = _find_box(mv, iprp[0], iprp[1], b"ipco")
        if ipco is None:
            return None
        # Ordered property list (1-based indices for ipma).
        props = list(_iter_boxes(mv, ipco[0], ipco[1]))

        def read_ispe(b0: int, b1: int) -> tuple[int, int] | None:
            if b1 - b0 < 12:
                return None
            w = int.from_bytes(mv[b0 + 4 : b0 + 8], "big")
            h = int.from_bytes(mv[b0 + 8 : b0 + 12], "big")
            return (w, h) if w and h else None

        # Property indices associated with the primary item (ipma).
        assoc: list[int] | None = None
        ipma = _find_box(mv, iprp[0], iprp[1], b"ipma")
        if ipma is not None and primary_id is not None:
            p = ipma[0]
            version = mv[p]
            flags = int.from_bytes(mv[p + 1 : p + 4], "big")
            p += 4
            entry_count = int.from_bytes(mv[p : p + 4], "big")
            p += 4
            for _ in range(entry_count):
                if version == 0:
                    item_id = int.from_bytes(mv[p : p + 2], "big")
                    p += 2
                else:
                    item_id = int.from_bytes(mv[p : p + 4], "big")
                    p += 4
                n_assoc = mv[p]
                p += 1
                ids = []
                for _ in range(n_assoc):
                    if flags & 1:
                        ids.append(int.from_bytes(mv[p : p + 2], "big") & 0x7FFF)
                        p += 2
                    else:
                        ids.append(mv[p] & 0x7F)
                        p += 1
                if item_id == primary_id:
                    assoc = ids
                    break

        size: tuple[int, int] | None = None
        rotated = False
        if assoc is not None:
            for idx in assoc:
                if not (1 <= idx <= len(props)):
                    continue
                t, b0, b1 = props[idx - 1]
                if t == b"ispe" and size is None:
                    size = read_ispe(b0, b1)
                elif t == b"irot" and b1 > b0:
                    rotated = (mv[b0] & 3) in (1, 3)  # 90 or 270 degrees
        if size is None:
            # No usable association: take the largest ispe (the primary
            # image dwarfs thumbnails in practice).
            best = None
            for t, b0, b1 in props:
                if t == b"ispe":
                    s = read_ispe(b0, b1)
                    if s and (best is None or s[0] * s[1] > best[0] * best[1]):
                        best = s
            size = best
        if size is None:
            return None
        return (size[1], size[0]) if rotated else size
    except (IndexError, ValueError):
        return None


def heic_backend_available() -> bool:
    try:
        import pillow_heif  # noqa: F401

        return True
    except ImportError:
        return False


def decode_heic_to_rgba(data: bytes, options: DecoderOptions | None = None) -> np.ndarray:
    options = options or DecoderOptions()
    custom = (options.custom_decoders or {}).get("heic")
    if custom is not None:
        return np.asarray(custom(data), dtype=np.uint8)
    try:
        import pillow_heif
        from PIL import Image

        pillow_heif.register_heif_opener()
        img = Image.open(io.BytesIO(data))
        return np.array(img.convert("RGBA"))
    except ImportError as exc:
        raise StitchError(
            "HEIC decoding requires a backend: install pillow-heif, or inject "
            "a decoder via DecoderOptions(custom_decoders={'heic': fn}) "
            "(reference parity: optional sharp/heic-decode peers, "
            "heic-decoder.ts:266-285)",
            exc,
        ) from exc
    except Exception as exc:
        # Error contract: hostile bytes surface as StitchError, never a raw
        # PIL/pillow-heif exception (same corruption-fuzz class as the JPEG
        # native tier).
        raise StitchError("HEIC decode failed", exc) from exc


class HeicDecoder:
    """Decode-once-then-stream HEIC decoder (reference: heic-decoder.ts:286-435)."""

    format = "heic"

    def __init__(self, source, options: DecoderOptions | None = None):
        self._options = options or DecoderOptions()
        if isinstance(source, (str, os.PathLike)):
            with open(source, "rb") as f:
                self._data = f.read()
        elif isinstance(source, (bytes, bytearray, memoryview)):
            self._data = bytes(source)
        elif isinstance(source, np.ndarray):
            self._data = source.tobytes()
        elif hasattr(source, "read"):
            self._data = source.read()
        else:
            raise StitchError(f"Unsupported HEIC source type: {type(source).__name__}")
        self._pixels: np.ndarray | None = None
        self._band_height = self._options.band_height or DEFAULT_BAND_HEIGHT

    def _decode(self) -> np.ndarray:
        if self._pixels is None:
            self._pixels = decode_heic_to_rgba(self._data, self._options)
        return self._pixels

    def get_header(self) -> ImageHeader:
        """Header from the ISO-BMFF metadata (ispe/irot of the primary item)
        — no decode, no backend needed. Falls back to decode-on-header only
        when the box parse finds nothing (the reference ALWAYS pays the full
        decode here, heic-decoder.ts:256-261, :326-360)."""
        size = parse_heic_header(self._data)
        if size is not None:
            return ImageHeader(
                width=size[0], height=size[1], channels=4, bit_depth=8,
                format="heic",
            )
        pixels = self._decode()
        return ImageHeader(
            width=pixels.shape[1],
            height=pixels.shape[0],
            channels=4,
            bit_depth=8,
            format="heic",
        )

    def bands(self, band_height: int | None = None) -> Iterator[np.ndarray]:
        band_height = band_height or self._band_height
        pixels = self._decode()
        h, w = pixels.shape[:2]
        flat = pixels.reshape(h, w * 4)
        for y0 in range(0, h, band_height):
            yield flat[y0 : y0 + band_height]

    def scanlines(self) -> Iterator[np.ndarray]:
        for band in self.bands():
            for row in band:
                yield row

    def close(self) -> None:
        self._pixels = None


class HeicFileDecoder(HeicDecoder):
    """File-path HEIC decoder (reference parity)."""


class HeicBufferDecoder(HeicDecoder):
    """Byte-buffer HEIC decoder (reference parity)."""


def heic_plugin():
    """(reference: heicDecoder plugin, heic-decoder.ts:437-460)."""
    from .registry import DecoderPlugin

    return DecoderPlugin(
        format="heic",
        create=lambda source, options=None: HeicDecoder(source, options),
    )
