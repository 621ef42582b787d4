"""Shared types and the full options surface.

Python-native equivalents of the reference's ``src/types.ts`` and
``src/decoders/types.ts``: ``PngHeader``, ``ImageHeader``, ``ColorType``,
``PositionedImage``, ``ImageSource``, ``DecoderOptions`` and ``ConcatOptions``
(reference src/types.ts:43-144). Options may be given as a ``ConcatOptions``
instance or a plain dict using either snake_case or the reference's camelCase
keys (``outputFormat``, ``jpegQuality``, ``backgroundColor``,
``enableAlphaBlending``, ``onProgress``, ``decoderOptions``).
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Mapping, Sequence

from .errors import StitchError


# Supported container formats (reference: ImageFormat, decoders/types.ts).
ImageFormat = str  # 'png' | 'jpeg' | 'heic'

# Aliases for reference type names; the single DecoderOptions covers both.
# (reference: JpegDecoderOptions / HeicDecoderOptions, decoders/types.ts:85-120)


class ColorType(enum.IntEnum):
    """PNG color types (reference: src/types.ts:149-155)."""

    GRAYSCALE = 0
    RGB = 2
    PALETTE = 3
    GRAYSCALE_ALPHA = 4
    RGBA = 6


@dataclass(frozen=True)
class PngHeader:
    """IHDR contents (reference: src/types.ts:16-24)."""

    width: int
    height: int
    bit_depth: int
    color_type: int
    compression_method: int = 0
    filter_method: int = 0
    interlace_method: int = 0


@dataclass(frozen=True)
class PngChunk:
    """One PNG chunk (reference: src/types.ts:6-11)."""

    length: int
    type: str
    data: bytes
    crc: int


@dataclass(frozen=True)
class ImageHeader:
    """Format-agnostic image header (reference: src/decoders/types.ts:9-30).

    ``metadata`` carries format specifics; for PNG it includes the full
    ``PngHeader`` plus palette/transparency tables when present.
    """

    width: int
    height: int
    channels: int
    bit_depth: int
    format: str
    metadata: Mapping[str, Any] = field(default_factory=dict)


@dataclass
class PositionedImage:
    """Free-form placement wrapper (reference: src/decoders/types.ts:126-143).

    ``z_index`` defaults to the input's index when omitted
    (reference: src/positioned-layout.ts:184).
    """

    x: int
    y: int
    source: Any
    z_index: int | None = None


@dataclass
class ImageSource:
    """Lazy input: known dimensions, deferred pixel decode
    (reference: src/decoders/types.ts:145-162)."""

    width: int
    height: int
    factory: Callable[[], Any]
    format: str | None = None


@dataclass
class DecoderOptions:
    """Per-format decoder knobs (reference: src/decoders/types.ts:85-120)."""

    # JPEG/HEIC: prefer the fast native tier (PIL) over the owned decoder.
    use_native_if_available: bool = True
    # Force the owned (from-scratch) decoders even when PIL is present.
    force_owned: bool = False
    # Band height used by streaming decoders (rows per device transfer).
    band_height: int | None = None
    # PNG: strict per-chunk CRC-32 + Adler-32 verification while streaming.
    # None = per-source default matching the reference: buffer inputs
    # verify (PngBufferDecoder routes through the CRC-checking
    # parsePngChunks, png-parser.ts:57-64, png-decoder.ts:359), file/stream
    # inputs skip for throughput (its fd chunk scan also skips CRC).
    # Explicit True/False overrides both.
    verify_crc: bool | None = None
    # Dependency injection hook for tests (reference customConstructors DI,
    # src/decoders/types.ts:77-80): maps format name -> decode callable.
    custom_decoders: Mapping[str, Callable[..., Any]] | None = None


@dataclass
class Layout:
    """Grid/canvas layout config (reference: src/types.ts:60-77)."""

    columns: int | None = None
    rows: int | None = None
    width: int | None = None
    height: int | None = None


BackgroundColor = (
    str | Sequence[int] | None
)


@dataclass
class ConcatOptions:
    """The whole configuration surface (reference: src/types.ts:43-144)."""

    inputs: Any  # sequence / iterable / generator of image inputs
    layout: Layout = field(default_factory=Layout)
    decoder_options: DecoderOptions = field(default_factory=DecoderOptions)
    decoders: Sequence[Any] | None = None  # explicit DecoderPlugin list
    output_format: str = "png"  # 'png' | 'jpeg'
    jpeg_quality: int = 85
    # '444' (reference parity, default) or '420' (2x2 chroma subsampling:
    # smaller files, faster chroma path).
    jpeg_sampling: str = "444"
    # Restart marker cadence in MCU rows (0 = none, reference parity).
    # Restart groups are byte-aligned and reset DC prediction, making the
    # entropy-coded segment a concatenation of independent chunks — the
    # enabler for sharded/parallel entropy coding (T.81 B.2.4.4, E.2.4).
    jpeg_restart_interval_rows: int = 0
    background_color: BackgroundColor = None
    enable_alpha_blending: bool = True
    on_progress: Callable[[int, int], None] | None = None
    # --- TPU-native extensions (not in the reference) ---
    # Rows per streamed band; the O(canvas_width * band_height) memory knob.
    band_height: int = 256
    # Canvas dimension ceiling (each axis; 0 = unlimited). The memory
    # contract is O(canvas_width): a corrupt or hostile header declaring a
    # ~2^31-pixel width would otherwise drive a clean but enormous band
    # allocation (fuzz-found MemoryError). 2^20 px/side = a 4 TB RGBA8
    # canvas streamed at ~200 MB/band — raise explicitly if you mean it.
    max_canvas_dim: int = 1 << 20
    # PNG deflate level (reference parity default: 6,
    # image-concat-core.ts:342). Lower = faster, larger output.
    png_compression_level: int = 6
    # zlib strategy for PNG output: 'default' | 'filtered' | 'rle'
    # ('filtered'/'rle' can be much faster on filtered scanline data).
    png_compression_strategy: str = "default"
    # The port runs on ``device``: 'torch' (the default; 'jax' and 'tpu'
    # too) unless the caller asks for the host tier with 'numpy'/'oracle'
    # (host float64 path matching the reference's JS semantics
    # bit-for-bit) or for the JAX package's policy with 'auto' (the host
    # tier for small canvases, the device above a threshold and over a fast
    # link; ops/backend.py). Every name gives the same bytes.
    backend: str = "torch"
    # Multi-chip scale-out: a jax.sharding.Mesh with axes ('band', 'x') or an
    # int device count (first N jax devices, factored near-square). Implies
    # the device backend for band programs; output bytes are identical to
    # single-chip (sharding is annotation-only).
    mesh: Any = None
    # Host decode parallelism: worker threads pulling per-input band rows
    # (the native inflate/defilter calls release the GIL, so separate tiles
    # decode on separate cores). 1 = serial decode (reference parity; the
    # reference is single-threaded Node, src/image-concat-core.ts); the PNG
    # deflate then has its own single compression worker, as the
    # reference's runtime zlib compresses off its JS thread. From 2 the
    # deflate's batches share the decode pool. 0 = auto
    # (STITCH_TPU_HOST_THREADS env, else 1). Output bytes are identical
    # at any setting: assembly order is deterministic.
    host_threads: int = 0

    _CAMEL = {
        "decoderOptions": "decoder_options",
        "outputFormat": "output_format",
        "jpegQuality": "jpeg_quality",
        "jpegSampling": "jpeg_sampling",
        "jpegRestartIntervalRows": "jpeg_restart_interval_rows",
        "backgroundColor": "background_color",
        "enableAlphaBlending": "enable_alpha_blending",
        "onProgress": "on_progress",
        "bandHeight": "band_height",
        "maxCanvasDim": "max_canvas_dim",
        "pngCompressionLevel": "png_compression_level",
        "pngCompressionStrategy": "png_compression_strategy",
        "hostThreads": "host_threads",
    }

    @classmethod
    def from_any(cls, options: "ConcatOptions | Mapping[str, Any]") -> "ConcatOptions":
        if isinstance(options, ConcatOptions):
            return options
        if not isinstance(options, Mapping):
            raise StitchError(
                f"options must be a ConcatOptions or mapping, got {type(options).__name__}"
            )
        known = {f.name for f in dataclasses.fields(cls) if not f.name.startswith("_")}
        kwargs: dict[str, Any] = {}
        for key, value in options.items():
            name = cls._CAMEL.get(key, key)
            if name not in known:
                raise StitchError(f"Unknown option: {key}")
            kwargs[name] = value
        if "layout" in kwargs and isinstance(kwargs["layout"], Mapping):
            kwargs["layout"] = Layout(**{str(k): v for k, v in kwargs["layout"].items()})
        if "decoder_options" in kwargs and isinstance(kwargs["decoder_options"], Mapping):
            dk = {}
            docamel = {
                "useNativeIfAvailable": "use_native_if_available",
                "forceOwned": "force_owned",
                "bandHeight": "band_height",
                "customDecoders": "custom_decoders",
                "verifyCrc": "verify_crc",
            }
            for key, value in kwargs["decoder_options"].items():
                dk[docamel.get(key, key)] = value
            kwargs["decoder_options"] = DecoderOptions(**dk)
        if "inputs" not in kwargs:
            raise StitchError("At least one input image is required")
        return cls(**kwargs)

    def validate(self) -> None:
        """Option validation (reference: src/image-concat-core.ts:287-300)."""
        inputs = self.inputs
        if inputs is None:
            raise StitchError("At least one input image is required")
        if isinstance(inputs, (list, tuple)) and len(inputs) == 0:
            raise StitchError("At least one input image is required")
        if self.output_format not in ("png", "jpeg"):
            raise StitchError(f"Unsupported output format: {self.output_format}")
        if not (1 <= int(self.jpeg_quality) <= 100):
            raise StitchError("JPEG quality must be between 1 and 100")
        if self.band_height < 1:
            raise StitchError("band_height must be >= 1")
        if int(self.jpeg_restart_interval_rows) < 0:
            raise StitchError("jpeg_restart_interval_rows must be >= 0")
        if int(self.host_threads) < 0:
            raise StitchError("host_threads must be >= 0")

    def resolved_host_threads(self) -> int:
        """Effective count of decode workers: explicit option, else the
        STITCH_TPU_HOST_THREADS env var, else 1 (serial decode). At 1 the
        PNG deflate compresses on one worker of its own, one batch in
        flight; from 2 on the decode pool
        (``TorchStreamingConcatenator._deflate_worker``)."""
        n = int(self.host_threads)
        if n == 0:
            import os

            n = int(os.environ.get("STITCH_TPU_HOST_THREADS", "1") or 1)
        return max(1, n)


def image_header_to_png_header(header: ImageHeader) -> PngHeader:
    """Map a format-agnostic header onto PNG terms for internal planning
    (reference: src/image-concat-core.ts:47-74)."""
    meta = header.metadata or {}
    png = meta.get("png_header")
    if isinstance(png, PngHeader):
        return png
    channels_to_color_type = {1: 0, 2: 4, 3: 2, 4: 6}
    color_type = channels_to_color_type.get(header.channels)
    if color_type is None:
        raise StitchError(f"Unsupported channel count: {header.channels}")
    return PngHeader(
        width=header.width,
        height=header.height,
        bit_depth=header.bit_depth,
        color_type=color_type,
    )
