"""Pixel format conversion, alpha compositing, and background colors.

Counterpart of the reference's ``src/pixel-ops.ts``, redesigned from per-pixel
JS loops (pixel-ops.ts:496-744) into whole-band array ops. Bands are
``(H, W, 4)`` RGBA arrays — ``uint8`` for 8-bit, ``uint16`` (native order) for
16-bit; big-endian byte layout only appears at PNG (de)serialization.

Semantics frozen from the reference:
- Common format is always RGBA; 16-bit iff any input is 16-bit
  (pixel-ops.ts:293-307).
- ``scale_sample`` rounding is round(v*toMax/fromMax) with JS ``Math.round``
  (= floor(x+0.5)) (pixel-ops.ts:312-326). Every depth conversion used here
  is exact in integers: b->8 multiplies by 255/(2^b-1) (an integer), 8->16 is
  *257, and 16->8 is (2v+257)//514 == floor(v/257 + 0.5).
- Alpha "over" in straight alpha, thresholds srcAlpha>=0.9999 (copy) /
  <=0.0001 (skip) and float64 math with Math.round (pixel-ops.ts:646-744).
  ``composite_band`` reproduces the JS float64 arithmetic exactly.
- BT.601 luma 0.299/0.587/0.114 for background colors (pixel-ops.ts:123).

Superset: paletted PNGs (color type 3) convert properly via PLTE/tRNS — the
reference throws on them (pixel-ops.ts:609-610).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..errors import StitchError
from ..utils import get_bytes_per_pixel, get_samples_per_pixel

NAMED_COLORS: dict[str, tuple[int, int, int, int]] = {
    # reference: pixel-ops.ts:38-49
    "black": (0, 0, 0, 255),
    "white": (255, 255, 255, 255),
    "red": (255, 0, 0, 255),
    "green": (0, 255, 0, 255),
    "blue": (0, 0, 255, 255),
    "yellow": (255, 255, 0, 255),
    "cyan": (0, 255, 255, 255),
    "magenta": (255, 0, 255, 255),
    "gray": (128, 128, 128, 255),
    "grey": (128, 128, 128, 255),
}


def js_round(x: np.ndarray | float) -> np.ndarray | int:
    """JS Math.round: floor(x + 0.5) (positive-half-away-from-zero)."""
    if np.isscalar(x):
        return int(np.floor(x + 0.5))
    return np.floor(np.asarray(x) + 0.5)


def parse_background_color(
    color: str | Sequence[int] | None,
) -> tuple[int, int, int, int]:
    """Parse hex/#RGB(A)/named/array colors to RGBA 0-255
    (reference: parseBackgroundColor, pixel-ops.ts:8-91)."""
    if color is None or color == "transparent":
        return (0, 0, 0, 0)

    if isinstance(color, (list, tuple, np.ndarray)):
        vals = list(color)
        if len(vals) == 3:
            r, g, b = vals
            a = 255
        elif len(vals) == 4:
            r, g, b, a = vals
        else:
            raise StitchError("Color array must have 3 (RGB) or 4 (RGBA) values")
        for v in (r, g, b, a):
            if not (isinstance(v, (int, np.integer)) and 0 <= int(v) <= 255):
                kind = "RGB" if len(vals) == 3 else "RGBA"
                raise StitchError(f"{kind} color values must be integers between 0 and 255")
        return (int(r), int(g), int(b), int(a))

    if not isinstance(color, str):
        raise StitchError(
            f"Unsupported color format: {color!r}. Use hex (#RRGGBB), RGB array [r,g,b], or named color"
        )

    lower = color.lower()
    if lower in NAMED_COLORS:
        return NAMED_COLORS[lower]

    if color.startswith("#"):
        hexpart = color[1:]
        try:
            if len(hexpart) in (3, 4):
                r = int(hexpart[0] * 2, 16)
                g = int(hexpart[1] * 2, 16)
                b = int(hexpart[2] * 2, 16)
                a = int(hexpart[3] * 2, 16) if len(hexpart) == 4 else 255
            elif len(hexpart) in (6, 8):
                r = int(hexpart[0:2], 16)
                g = int(hexpart[2:4], 16)
                b = int(hexpart[4:6], 16)
                a = int(hexpart[6:8], 16) if len(hexpart) == 8 else 255
            else:
                raise StitchError(
                    f"Invalid hex color format: {color}. Expected #RGB, #RGBA, #RRGGBB, or #RRGGBBAA"
                )
        except ValueError as exc:
            raise StitchError(f"Invalid hex color: {color}") from exc
        return (r, g, b, a)

    raise StitchError(
        f"Unsupported color format: {color}. Use hex (#RRGGBB), RGB array [r,g,b], or named color"
    )


def _scale8_to_depth(value: int, bit_depth: int) -> int:
    """Scale an 8-bit sample to ``bit_depth`` (reference: pixel-ops.ts:101-113)."""
    if bit_depth == 16:
        return value * 257  # round(v*65535/255) exactly
    if bit_depth == 8:
        return value
    max_val = (1 << bit_depth) - 1
    return int(js_round(value * max_val / 255))


def rgba_to_color_type(
    rgba: tuple[int, int, int, int], color_type: int, bit_depth: int
) -> bytes:
    """Serialize an RGBA color into a single pixel's raw bytes for a given
    PNG format (reference: rgbaToColorType, pixel-ops.ts:94-290)."""
    r, g, b, a = rgba

    def w16(v: int) -> bytes:
        return bytes([(v >> 8) & 0xFF, v & 0xFF])

    if color_type == 0:
        gray = int(js_round(0.299 * r + 0.587 * g + 0.114 * b))
        sv = _scale8_to_depth(gray, bit_depth)
        return w16(sv) if bit_depth == 16 else bytes([sv])
    if color_type == 2:
        if bit_depth == 16:
            return w16(_scale8_to_depth(r, 16)) + w16(_scale8_to_depth(g, 16)) + w16(
                _scale8_to_depth(b, 16)
            )
        return bytes([r, g, b])
    if color_type == 4:
        gray = int(js_round(0.299 * r + 0.587 * g + 0.114 * b))
        if bit_depth == 16:
            return w16(_scale8_to_depth(gray, 16)) + w16(_scale8_to_depth(a, 16))
        return bytes([gray, a])
    if color_type == 6:
        if bit_depth == 16:
            return (
                w16(_scale8_to_depth(r, 16))
                + w16(_scale8_to_depth(g, 16))
                + w16(_scale8_to_depth(b, 16))
                + w16(_scale8_to_depth(a, 16))
            )
        return bytes([r, g, b, a])
    raise StitchError(f"Unsupported color type: {color_type}")


def get_transparent_color(
    color_type: int,
    bit_depth: int,
    background_color: str | Sequence[int] | None = None,
) -> bytes:
    """Single-pixel background byte pattern
    (reference: getTransparentColor, pixel-ops.ts:255-331)."""
    if background_color is not None:
        return rgba_to_color_type(
            parse_background_color(background_color), color_type, bit_depth
        )
    bytes_per_sample = 2 if bit_depth == 16 else 1
    samples = get_samples_per_pixel(color_type)
    return bytes(samples * bytes_per_sample)


def background_pixel(
    bit_depth: int, background_color: str | Sequence[int] | None = None
) -> np.ndarray:
    """Background color as a (4,) RGBA array in the band dtype."""
    rgba = parse_background_color(background_color)
    dtype = np.uint16 if bit_depth == 16 else np.uint8
    if bit_depth == 16:
        return np.array([v * 257 for v in rgba], dtype=dtype)
    return np.array(rgba, dtype=dtype)


def determine_common_format(headers: Sequence) -> tuple[int, int]:
    """(bit_depth, color_type): always RGBA, 16-bit iff any input is 16-bit
    (reference: determineCommonFormat, pixel-ops.ts:293-307)."""
    max_depth = 8
    for header in headers:
        if header.bit_depth == 16:
            max_depth = 16
    return max_depth, 6


def scale_sample(value: int, from_bits: int, to_bits: int) -> int:
    """Exact scalar sample rescale (reference: scaleSample, pixel-ops.ts:312-326)."""
    if from_bits == to_bits:
        return value
    from_max = (1 << from_bits) - 1
    to_max = (1 << to_bits) - 1
    return int(js_round(value * to_max / from_max))


def _scale_array(values: np.ndarray, from_bits: int, to_bits: int) -> np.ndarray:
    """Exact integer array version of ``scale_sample``."""
    if from_bits == to_bits:
        return values
    from_max = (1 << from_bits) - 1
    to_max = (1 << to_bits) - 1
    if to_max % from_max == 0:
        # Scaling up between full-range depths is an exact multiply.
        return values.astype(np.uint32) * (to_max // from_max)
    # General case: round(v*toMax/fromMax) == (2*v*toMax + fromMax) // (2*fromMax).
    v = values.astype(np.uint64)
    return (2 * v * to_max + from_max) // (2 * from_max)


def _unpack_subbyte(raw: np.ndarray, width: int, bit_depth: int) -> np.ndarray:
    """Unpack 1/2/4-bit samples (MSB-first) from (H, row_bytes) to (H, width)
    (reference bit extraction: pixel-ops.ts:533-537).

    Per-depth shift/mask fast paths (same rework as ops/adam7): the
    generic unpackbits + weighted-sum form paid a ufunc reduce per call,
    which dominated tiny sub-byte tiles."""
    if bit_depth == 4:
        out = np.empty((raw.shape[0], raw.shape[1] * 2), dtype=np.uint8)
        out[:, 0::2] = raw >> 4
        out[:, 1::2] = raw & 0x0F
        return out[:, :width]
    if bit_depth == 2:
        out = np.empty((raw.shape[0], raw.shape[1] * 4), dtype=np.uint8)
        for k in range(4):
            out[:, k::4] = (raw >> (6 - 2 * k)) & 0x03
        return out[:, :width]
    return np.unpackbits(raw, axis=1)[:, :width]  # bit_depth == 1


def _read_samples(
    raw: np.ndarray, width: int, bit_depth: int, samples: int
) -> np.ndarray:
    """Decode raw scanline bytes to (H, width, samples) integer samples."""
    h = raw.shape[0]
    if bit_depth == 16:
        pairs = raw[:, : width * samples * 2].reshape(h, width * samples, 2)
        vals = (pairs[:, :, 0].astype(np.uint16) << 8) | pairs[:, :, 1]
        return vals.reshape(h, width, samples)
    if bit_depth == 8:
        return raw[:, : width * samples].reshape(h, width, samples)
    if samples != 1:
        raise StitchError(
            f"Sub-byte bit depth {bit_depth} only valid for 1-sample color types"
        )
    return _unpack_subbyte(raw, width, bit_depth)[:, :, None]


def convert_band(
    raw: np.ndarray,
    width: int,
    bit_depth: int,
    color_type: int,
    target_bit_depth: int,
    palette: np.ndarray | None = None,
    trns: np.ndarray | None = None,
    allow_palette: bool = True,
    copy: bool = True,
) -> np.ndarray:
    """Convert a band of raw scanlines to RGBA (reference: convertScanline,
    pixel-ops.ts:496-744, lifted from per-pixel loops to whole-band ops).

    ``raw``: (H, row_bytes) uint8 in source format. Returns (H, width, 4) in
    the target dtype (uint8 or uint16, native order).

    ``copy=False`` lets the RGBA8 identity path return a zero-copy VIEW of
    ``raw`` — only for callers that own ``raw`` (a freshly defiltered band)
    and treat the result as read-only; it deletes a full band-sized memcpy
    from the grid hot loop.
    """
    raw = np.atleast_2d(np.asarray(raw, dtype=np.uint8))
    h = raw.shape[0]
    out_dtype = np.uint16 if target_bit_depth == 16 else np.uint8
    max_a = 0xFFFF if target_bit_depth == 16 else 0xFF

    if bit_depth == 8 and target_bit_depth == 8 and trns is None:
        # Identity fast paths (the overwhelmingly common tile formats):
        # one copy instead of the generic read/scale/assign chain — worth
        # ~10% on many-tiny-tile configs where numpy call overhead rules.
        if color_type == 6:
            view = raw[:, : width * 4].reshape(h, width, 4)
            return view if not copy else np.array(view)
        if color_type == 2:
            from ..native import expand_to_rgba_native

            rgb = raw[:, : width * 3]
            out = expand_to_rgba_native(rgb, 3)
            if out is not None:
                return out.reshape(h, width, 4)
            out = np.empty((h, width, 4), dtype=np.uint8)
            out[:, :, :3] = rgb.reshape(h, width, 3)
            out[:, :, 3] = 255
            return out
        if color_type == 0:
            from ..native import expand_to_rgba_native

            out = expand_to_rgba_native(raw[:, :width], 1)
            if out is not None:
                return out.reshape(h, width, 4)

    out = np.empty((h, width, 4), dtype=out_dtype)

    if color_type == 0:  # grayscale
        gray = _read_samples(raw, width, bit_depth, 1)[:, :, 0]
        g = _scale_array(gray, bit_depth, target_bit_depth).astype(out_dtype)
        out[:, :, 0] = g
        out[:, :, 1] = g
        out[:, :, 2] = g
        out[:, :, 3] = max_a
        if trns is not None and len(trns) >= 2:
            # Color-key transparency (superset): tRNS stores the key at the
            # source bit depth in a 16-bit field.
            key = (int(trns[0]) << 8) | int(trns[1])
            out[:, :, 3] = np.where(gray == key, 0, max_a).astype(out_dtype)
    elif color_type == 2:  # RGB
        rgb = _read_samples(raw, width, bit_depth, 3)
        out[:, :, :3] = _scale_array(rgb, bit_depth, target_bit_depth).astype(out_dtype)
        out[:, :, 3] = max_a
        if trns is not None and len(trns) >= 6:
            keys = [
                (int(trns[2 * i]) << 8) | int(trns[2 * i + 1]) for i in range(3)
            ]
            match = (
                (rgb[:, :, 0] == keys[0])
                & (rgb[:, :, 1] == keys[1])
                & (rgb[:, :, 2] == keys[2])
            )
            out[:, :, 3] = np.where(match, 0, max_a).astype(out_dtype)
    elif color_type == 3:  # palette (superset; reference throws here)
        if not allow_palette or palette is None:
            raise StitchError(
                "Palette PNGs (color type 3) require a PLTE table"
                if allow_palette
                else "Unsupported source color type: 3"
            )
        idx = _read_samples(raw, width, bit_depth, 1)[:, :, 0].astype(np.int64)
        pal = np.asarray(palette, dtype=np.uint8)
        if idx.max(initial=0) >= pal.shape[0]:
            raise StitchError(
                f"Palette index {int(idx.max())} out of range for {pal.shape[0]}-entry PLTE"
            )
        rgb = pal[idx]  # (H, W, 3), 8-bit
        if trns is not None:
            alpha_lut = np.full(pal.shape[0], 255, dtype=np.uint8)
            alpha_lut[: len(trns)] = np.asarray(trns, dtype=np.uint8)
            alpha = alpha_lut[idx]
        else:
            alpha = np.full((h, width), 255, dtype=np.uint8)
        out[:, :, :3] = _scale_array(rgb, 8, target_bit_depth).astype(out_dtype)
        out[:, :, 3] = _scale_array(alpha, 8, target_bit_depth).astype(out_dtype)
    elif color_type == 4:  # gray + alpha
        ga = _read_samples(raw, width, bit_depth, 2)
        g = _scale_array(ga[:, :, 0], bit_depth, target_bit_depth).astype(out_dtype)
        out[:, :, 0] = g
        out[:, :, 1] = g
        out[:, :, 2] = g
        out[:, :, 3] = _scale_array(ga[:, :, 1], bit_depth, target_bit_depth).astype(
            out_dtype
        )
    elif color_type == 6:  # RGBA
        rgba = _read_samples(raw, width, bit_depth, 4)
        out[:, :, :] = _scale_array(rgba, bit_depth, target_bit_depth).astype(out_dtype)
    else:
        raise StitchError(f"Unsupported source color type: {color_type}")
    return out


def convert_scanline(
    src_scanline: np.ndarray,
    width: int,
    src_bit_depth: int,
    src_color_type: int,
    target_bit_depth: int,
    target_color_type: int,
    **kwargs,
) -> np.ndarray:
    """Single-row byte-level API matching the reference's ``convertScanline``.

    Returns the converted row as raw RGBA bytes (big-endian for 16-bit),
    matching the reference's byte layout (pixel-ops.ts:616-641).
    """
    if target_color_type != 6:
        raise StitchError("Only conversion to RGBA (color type 6) is supported")
    band = convert_band(
        np.asarray(src_scanline, dtype=np.uint8)[None, :],
        width,
        src_bit_depth,
        src_color_type,
        target_bit_depth,
        **kwargs,
    )
    return band_to_bytes(band)[0]


def band_to_bytes(band: np.ndarray) -> np.ndarray:
    """(H, W, 4) native-dtype band -> (H, W*bpp) big-endian raw bytes."""
    h = band.shape[0]
    if band.dtype == np.uint16:
        return np.ascontiguousarray(band.astype(">u2")).view(np.uint8).reshape(h, -1)
    return np.ascontiguousarray(band).reshape(h, -1)


def bytes_to_band(rows: np.ndarray, width: int, bit_depth: int) -> np.ndarray:
    """(H, W*bpp) big-endian RGBA raw bytes -> (H, W, 4) native-dtype band."""
    rows = np.atleast_2d(np.asarray(rows, dtype=np.uint8))
    h = rows.shape[0]
    if bit_depth == 16:
        return (
            rows.reshape(h, width, 4, 2).astype(np.uint16)[:, :, :, 0] << 8
        ) | rows.reshape(h, width, 4, 2)[:, :, :, 1]
    return rows.reshape(h, width, 4)


def convert_pixel_format(
    src_data: np.ndarray,
    src_header,
    target_bit_depth: int,
    target_color_type: int,
    **kwargs,
):
    """Whole-image batch conversion (reference: convertPixelFormat,
    pixel-ops.ts:332-492). ``src_data`` is raw scanline bytes (H*row_bytes
    flat or (H, row_bytes)); returns (data, header) like the reference."""
    from ..types import PngHeader
    from ..utils import scanline_byte_length

    if (
        src_header.bit_depth == target_bit_depth
        and src_header.color_type == target_color_type
    ):
        return np.asarray(src_data, dtype=np.uint8), src_header
    if target_color_type != 6:
        raise StitchError("Only conversion to RGBA (color type 6) is supported")
    row_bytes = scanline_byte_length(
        src_header.width, src_header.bit_depth, src_header.color_type
    )
    rows = np.asarray(src_data, dtype=np.uint8).reshape(src_header.height, row_bytes)
    band = convert_band(
        rows,
        src_header.width,
        src_header.bit_depth,
        src_header.color_type,
        target_bit_depth,
        **kwargs,
    )
    out_header = PngHeader(
        width=src_header.width,
        height=src_header.height,
        bit_depth=target_bit_depth,
        color_type=target_color_type,
        compression_method=src_header.compression_method,
        filter_method=src_header.filter_method,
        interlace_method=src_header.interlace_method,
    )
    return band_to_bytes(band), out_header


def copy_pixel_region(
    src: np.ndarray,
    src_width: int,
    dest: np.ndarray,
    dest_width: int,
    src_x: int,
    src_y: int,
    dest_x: int,
    dest_y: int,
    region_w: int,
    region_h: int,
    bytes_per_pixel: int = 4,
) -> None:
    """Copy a rectangle between flat raw-byte images (reference:
    copyPixelRegion, pixel-ops.ts:172-197)."""
    src2 = np.asarray(src, dtype=np.uint8).reshape(-1, src_width * bytes_per_pixel)
    dst2 = dest.reshape(-1, dest_width * bytes_per_pixel)
    dst2[
        dest_y : dest_y + region_h,
        dest_x * bytes_per_pixel : (dest_x + region_w) * bytes_per_pixel,
    ] = src2[
        src_y : src_y + region_h,
        src_x * bytes_per_pixel : (src_x + region_w) * bytes_per_pixel,
    ]


def fill_pixel_region(
    dest: np.ndarray,
    dest_width: int,
    x: int,
    y: int,
    region_w: int,
    region_h: int,
    color: bytes | Sequence[int],
    bytes_per_pixel: int = 4,
) -> None:
    """Fill a rectangle with a single pixel value (reference:
    fillPixelRegion, pixel-ops.ts:200-224)."""
    px = np.frombuffer(bytes(bytearray(color)), dtype=np.uint8)
    dst2 = dest.reshape(-1, dest_width * bytes_per_pixel)
    region = dst2[
        y : y + region_h, x * bytes_per_pixel : (x + region_w) * bytes_per_pixel
    ].reshape(region_h, region_w, bytes_per_pixel)
    region[:] = px[:bytes_per_pixel]


def create_blank_image(
    width: int,
    height: int,
    color_type: int = 6,
    bit_depth: int = 8,
    background_color=None,
) -> np.ndarray:
    """Allocate raw image bytes filled with a background color (reference:
    createBlankImage, pixel-ops.ts:227-252)."""
    px = np.frombuffer(
        get_transparent_color(color_type, bit_depth, background_color), dtype=np.uint8
    )
    bpp = get_bytes_per_pixel(bit_depth, color_type)
    out = np.empty(height * width * bpp, dtype=np.uint8)
    out.reshape(-1, bpp)[:] = px
    return out


def composite_band(
    dest: np.ndarray,
    src: np.ndarray,
    start_x: int = 0,
    use_alpha_blending: bool = True,
) -> None:
    """Porter-Duff "over" of ``src`` onto ``dest`` in place at column
    ``start_x`` (reference: compositeScanline, pixel-ops.ts:646-744).

    Both are (H, W, 4) bands of the same dtype. Reproduces the reference's
    float64 arithmetic bit-for-bit: straight alpha, copy when srcAlpha >=
    0.9999, skip when <= 0.0001, Math.round + clamp on the blend.
    """
    h, w = src.shape[:2]
    region = dest[:, start_x : start_x + w]
    if not use_alpha_blending:
        region[:] = src
        return

    # Native tier: identical float64 arithmetic in C++ (~100x the numpy
    # path); falls through to the numpy oracle when unavailable.
    try:
        from ..native import composite_native

        tmp = np.ascontiguousarray(region)
        if composite_native(tmp, np.ascontiguousarray(src)):
            region[:] = tmp
            return
    except Exception:
        pass

    max_val = 65535.0 if dest.dtype == np.uint16 else 255.0
    src_a = src[:, :, 3].astype(np.float64) / max_val
    dst_a = region[:, :, 3].astype(np.float64) / max_val

    copy_mask = src_a >= 0.9999
    blend_mask = (~copy_mask) & (src_a > 0.0001)

    out_a = src_a + dst_a * (1.0 - src_a)
    write_mask = blend_mask & (out_a > 0.0001)

    # Blend RGB in float64, matching the JS expression order exactly.
    s_rgb = src[:, :, :3].astype(np.float64)
    d_rgb = region[:, :, :3].astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        blended = (
            s_rgb * src_a[:, :, None] + d_rgb * dst_a[:, :, None] * (1.0 - src_a[:, :, None])
        ) / out_a[:, :, None]
    blended = np.floor(np.clip(np.nan_to_num(blended), 0.0, max_val) + 0.5)
    new_a = np.floor(out_a * max_val + 0.5)

    dtype = dest.dtype
    region[:, :, :3] = np.where(
        write_mask[:, :, None], blended.astype(dtype), region[:, :, :3]
    )
    region[:, :, 3] = np.where(write_mask, new_a.astype(dtype), region[:, :, 3])
    region[:] = np.where(copy_mask[:, :, None], src, region)


def composite_scanline(
    dest: np.ndarray,
    source: np.ndarray,
    start_x: int,
    source_width: int,
    bytes_per_pixel: int,
    use_alpha_blending: bool,
) -> None:
    """Byte-level single-row API matching the reference's signature
    (pixel-ops.ts:646-744). ``dest``/``source`` are raw RGBA byte rows."""
    bit_depth = 16 if bytes_per_pixel == 8 else 8
    dest_w = dest.shape[-1] // bytes_per_pixel
    dband = bytes_to_band(dest, dest_w, bit_depth)
    sband = bytes_to_band(
        np.asarray(source)[..., : source_width * bytes_per_pixel], source_width, bit_depth
    )
    composite_band(dband, sband, start_x, use_alpha_blending)
    dest[...] = band_to_bytes(dband)[0]


def extract_scanline_portion(
    scanline: np.ndarray, offset_x: int, width: int, bytes_per_pixel: int
) -> np.ndarray:
    """Clip a row horizontally (reference: extractScanlinePortion,
    pixel-ops.ts:747-756)."""
    start = offset_x * bytes_per_pixel
    return scanline[start : start + width * bytes_per_pixel]
