"""JPEG decoder: header-only SOF parse + tiered full decode.

Counterpart of the reference's ``src/decoders/jpeg-decoder.ts``: the header
comes from a marker walk without pixel decode (:46-97); pixels decode once
and then stream out as scanlines/bands because JPEG can't stream rows
(BaseJpegDecoder.scanlines, :317-332). Backend tiers mirror the reference's
sharp(native) → jpeg-js(owned) selection (:241-279): here the fast native
tier is PIL (libjpeg-turbo) and the owned tier is the from-scratch baseline
decoder in :mod:`image_stitch_tpu.codecs.jpeg.owned_decoder` (host Huffman +
device IDCT).
"""

from __future__ import annotations

import io
import os
from typing import Iterator

import numpy as np

from ...errors import StitchError
from ...types import DecoderOptions, ImageHeader
from ...utils.observability import span
from .parser import parse_jpeg_header

DEFAULT_BAND_HEIGHT = 256


def _pil_available() -> bool:
    try:
        import PIL  # noqa: F401

        return True
    except ImportError:  # pragma: no cover
        return False


def decode_jpeg_to_rgba(data: bytes, options: DecoderOptions | None = None) -> np.ndarray:
    """Full decode to (H, W, 4) uint8 through the configured tier
    (reference backend selection: jpeg-decoder.ts:241-279)."""
    options = options or DecoderOptions()
    custom = (options.custom_decoders or {}).get("jpeg")
    if custom is not None:
        return np.asarray(custom(data), dtype=np.uint8)
    use_pil = options.use_native_if_available and not options.force_owned
    if use_pil and _pil_available():
        from PIL import Image

        try:
            img = Image.open(io.BytesIO(data))
            if img.mode in ("RGB", "L"):
                # Decode in the file's own mode and expand with the AVX2
                # RGB/gray->RGBA kernel: skips PIL's whole-image convert
                # AND moves 25% fewer bytes through tobytes (RGB) — ~13%
                # of the PIL tier per 1024px tile. (A numpy strided 3->4
                # assign was tried first and measured 0.76x vs PIL's
                # convert loop; the native shuffle kernel is ~10x that.)
                from ...native import expand_to_rgba_native

                img.load()
                w, h = img.size
                ch = 3 if img.mode == "RGB" else 1
                src = np.frombuffer(img.tobytes(), np.uint8)
                out = expand_to_rgba_native(src, ch)
                if out is not None:
                    return out.reshape(h, w, 4)
                img = img.convert("RGBA")
            elif img.mode != "RGBA":
                img = img.convert("RGBA")
            w, h = img.size
            # frombuffer over tobytes: np.array(img) would route through
            # PIL's __array_interface__, which also calls tobytes() and then
            # copies a second time (~8% of the PIL tier per 1024px tile).
            # NOTE: the result is READ-ONLY (a view over the bytes object);
            # callers that mutate decoded pixels in place must copy first.
            # Internal pipeline paths always copy during format conversion.
            return np.frombuffer(img.tobytes(), np.uint8).reshape(h, w, 4)
        except Exception as exc:
            # Error contract: hostile bytes surface as StitchError, never a
            # raw PIL OSError/ValueError (corruption-fuzz find — the owned
            # tier already kept the contract).
            raise StitchError("JPEG decode failed (PIL tier)", exc) from exc
    from .owned_decoder import decode_baseline_jpeg

    rgb = decode_baseline_jpeg(data)
    h, w = rgb.shape[:2]
    out = np.empty((h, w, 4), dtype=np.uint8)
    out[:, :, :3] = rgb
    out[:, :, 3] = 255
    return out


class JpegDecoder:
    """Decode-once-then-stream JPEG decoder (reference: BaseJpegDecoder,
    jpeg-decoder.ts:281-341)."""

    format = "jpeg"
    # Safe producer for a shared decode-once cache entry: the source is
    # fully in memory (no fd) and decode is whole-image anyway — sharing
    # one _pixels array across duplicates strictly reduces memory.
    cache_shareable = True

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
            raise StitchError(f"Unsupported JPEG source type: {type(source).__name__}")
        self._header: ImageHeader | None = None
        self._pixels: np.ndarray | None = None
        self._dev_decoder = None  # None = untried, False = unavailable
        self._band_height = self._options.band_height or DEFAULT_BAND_HEIGHT

    def get_header(self) -> ImageHeader:
        """Header-only parse — no pixel decode (jpeg-decoder.ts:46-97)."""
        if self._header is None:
            parsed = parse_jpeg_header(self._data)
            # Internally we stream RGBA; report 4 channels like the
            # reference's normalized decode output.
            self._header = ImageHeader(
                width=parsed.width,
                height=parsed.height,
                channels=4,
                bit_depth=8,
                format="jpeg",
                metadata=parsed.metadata,
            )
        return self._header

    def _decode(self) -> np.ndarray:
        if self._pixels is None:
            self._pixels = decode_jpeg_to_rgba(self._data, self._options)
            header = self.get_header()
            if self._pixels.shape[:2] != (header.height, header.width):
                raise StitchError(
                    f"JPEG decode size mismatch: header says "
                    f"{header.width}x{header.height}, decoded "
                    f"{self._pixels.shape[1]}x{self._pixels.shape[0]}"
                )
        return self._pixels

    def bands(self, band_height: int | None = None) -> Iterator[np.ndarray]:
        """(h, W*4) raw RGBA byte rows in bands."""
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

    def device_band_decoder(self, device):
        """The device band tier for this stream on ``device`` (host Huffman
        once, cached): random-access ``decode_band`` of RGBA on the
        device, bit-identical to the host tiers. None when the stream is
        outside the tier's bounds (DeviceJpegDecoder.safe), the header
        disagrees, or pixels are contract-defined by an injected custom
        decoder."""
        if (self._options.custom_decoders or {}).get("jpeg") is not None:
            return None
        if self._dev_decoder is None:
            dev = None
            try:
                from .device_decoder import DeviceJpegDecoder

                with span("decode.jpeg.open", len(self._data)):
                    cand = DeviceJpegDecoder(self._data, device)
                hdr = self.get_header()
                if cand.safe and (cand.width, cand.height) == (
                    hdr.width, hdr.height
                ):
                    dev = cand
            except StitchError:
                dev = None
            self._dev_decoder = dev if dev is not None else False
        return self._dev_decoder.to(device) if self._dev_decoder else None

    def close(self) -> None:
        self._pixels = None
        self._dev_decoder = None


class JpegFileDecoder(JpegDecoder):
    """File-path JPEG decoder (reference: JpegFileDecoder, jpeg-decoder.ts:343)."""


class JpegBufferDecoder(JpegDecoder):
    """Byte-buffer JPEG decoder (reference: JpegBufferDecoder, jpeg-decoder.ts:381)."""


def jpeg_plugin():
    """(reference: jpegDecoder plugin, jpeg-decoder.ts:390-413)."""
    from ..registry import DecoderPlugin

    return DecoderPlugin(
        format="jpeg",
        create=lambda source, options=None: JpegDecoder(source, options),
    )
