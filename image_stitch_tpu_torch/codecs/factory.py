"""Decoder factory: turn any supported input into an ``ImageDecoder``.

Counterpart of the reference's ``src/decoders/decoder-factory.ts``:
``create_decoder`` unwraps ``PositionedImage`` (extractSource,
decoder-factory.ts:87-113), passes through existing decoders (:126-133),
wraps lazy ``ImageSource`` inputs in a deferred decoder (LazyImageDecoder,
:43-85), and otherwise magic-byte detects the format and dispatches to a
plugin (:143-193). ``create_decoders`` builds all decoders up front
(:216-264); positioned-mode guards mirror :285-321.
"""

from __future__ import annotations

import os
from typing import Any, Iterable, Mapping, Sequence

from ..errors import StitchError
from ..types import DecoderOptions, ImageHeader, ImageSource, PositionedImage
from .detect import detect_image_format
from .registry import DecoderPlugin, get_default_decoder_plugins


def _is_decoder(obj: Any) -> bool:
    return (
        hasattr(obj, "get_header")
        and hasattr(obj, "scanlines")
        and hasattr(obj, "close")
    )


class LazyImageDecoder:
    """Defers the inner decoder until pixels are first needed; the header
    comes from the declared metadata (reference: LazyImageDecoder,
    decoder-factory.ts:43-85). Used so huge grids don't allocate every
    input up front."""

    def __init__(self, source: ImageSource, options: DecoderOptions, plugins):
        self._source = source
        self._options = options
        self._plugins = plugins
        self._inner = None
        self._factory_calls = 0

    @property
    def factory_calls(self) -> int:
        return self._factory_calls

    def get_header(self) -> ImageHeader:
        if self._inner is not None:
            return self._inner.get_header()
        fmt = self._source.format or "png"
        channels = 4
        return ImageHeader(
            width=self._source.width,
            height=self._source.height,
            channels=channels,
            bit_depth=8,
            format=fmt,
        )

    def _materialize(self):
        if self._inner is None:
            self._factory_calls += 1
            produced = self._source.factory()
            self._inner = create_decoder(produced, self._options, self._plugins)
            inner_header = self._inner.get_header()
            if (
                inner_header.width != self._source.width
                or inner_header.height != self._source.height
            ):
                raise StitchError(
                    f"ImageSource declared {self._source.width}x{self._source.height} "
                    f"but produced {inner_header.width}x{inner_header.height}"
                )
        return self._inner

    def scanlines(self):
        # Generator: the factory must not run until rows are actually
        # pulled (deferred decode is the whole point of ImageSource).
        yield from self._materialize().scanlines()

    def bands(self, band_height=None):
        def gen():
            inner = self._materialize()
            if hasattr(inner, "bands"):
                yield from inner.bands(band_height)
            else:
                yield from _bands_from_scanlines(inner, band_height or 256)

        return gen()

    def close(self) -> None:
        if self._inner is not None:
            self._inner.close()


def _bands_from_scanlines(decoder, band_height: int):
    """Adapter for row-only decoders."""
    import numpy as np

    rows = []
    for row in decoder.scanlines():
        rows.append(np.asarray(row, dtype=np.uint8))
        if len(rows) == band_height:
            yield np.stack(rows)
            rows = []
    if rows:
        yield np.stack(rows)


def extract_source(input_obj: Any) -> Any:
    """Unwrap PositionedImage (reference: extractSource,
    decoder-factory.ts:87-113)."""
    if isinstance(input_obj, PositionedImage):
        return input_obj.source
    if isinstance(input_obj, Mapping) and "source" in input_obj and "x" in input_obj:
        return input_obj["source"]
    return input_obj


def is_positioned(input_obj: Any) -> bool:
    if isinstance(input_obj, PositionedImage):
        return True
    return (
        isinstance(input_obj, Mapping)
        and "source" in input_obj
        and "x" in input_obj
        and "y" in input_obj
    )


def has_positioned_images(inputs: Sequence[Any]) -> bool:
    """(reference: hasPositionedImages, decoder-factory.ts:285-291)."""
    return any(is_positioned(i) for i in inputs)


def extract_positions(inputs: Sequence[Any]) -> list[dict | None]:
    """(reference: extractPositions, decoder-factory.ts:293-306)."""
    out: list[dict | None] = []
    for i in inputs:
        if isinstance(i, PositionedImage):
            out.append({"x": i.x, "y": i.y, "z_index": i.z_index})
        elif is_positioned(i):
            out.append(
                {
                    "x": i["x"],
                    "y": i["y"],
                    "z_index": i.get("z_index", i.get("zIndex")),
                }
            )
        else:
            out.append(None)
    return out


def validate_positioned_inputs(inputs: Sequence[Any]) -> None:
    """All-or-nothing positioned mode (reference: validatePositionedInputs,
    decoder-factory.ts:308-321)."""
    positioned = [is_positioned(i) for i in inputs]
    if any(positioned) and not all(positioned):
        raise StitchError(
            "Cannot mix positioned and non-positioned images. "
            "If any input is positioned, all inputs must be positioned."
        )


def create_decoder(
    input_obj: Any,
    options: DecoderOptions | None = None,
    plugins: Sequence[DecoderPlugin] | None = None,
):
    """(reference: createDecoder, decoder-factory.ts:116-214)."""
    options = options or DecoderOptions()
    plugins = list(plugins) if plugins is not None else get_default_decoder_plugins()
    source = extract_source(input_obj)

    if _is_decoder(source):
        return source
    if isinstance(source, ImageSource):
        return LazyImageDecoder(source, options, plugins)
    from .array_source import ArrayDecoder, is_pixel_array

    if is_pixel_array(source):
        # Raw (H, W, 3|4) pixel arrays are first-class inputs — the
        # canvas-input analog (image-concat-browser.ts:287-323).
        return ArrayDecoder(source, options)

    from .detect import read_magic_and_source

    # Path sources were never identity-cacheable and must stay that way:
    # the small-file slurp below turns a path into a FRESH bytes object per
    # call, so routing it into the id()-keyed input cache would retain one
    # fully-decoded entry per call with zero dedup benefit.
    was_path = isinstance(source, (str, os.PathLike))
    magic, source = read_magic_and_source(source)
    if was_path and options.verify_crc is None:
        # The small-file slurp below hands the decoder a BUFFER, but CRC
        # posture follows the USER-visible source type: the reference's
        # file decoder skips per-chunk CRC on its fd scan while its buffer
        # decoder verifies (png-decoder.ts:235 vs :359). Without this pin
        # the slurp silently upgraded path inputs to strict (~12% on the
        # pngsuite many-tiny-tile config).
        from dataclasses import replace

        options = replace(options, verify_crc=False)
    fmt = detect_image_format(magic)
    if fmt is None:
        raise StitchError(
            "Unsupported or unrecognized image format (checked PNG/JPEG/HEIC magic bytes)"
        )
    for plugin in plugins:
        if plugin.format == fmt:
            if not was_path:
                from .input_cache import cached_decoder_for

                cached = cached_decoder_for(
                    source, lambda: plugin.create(source, options)
                )
                if cached is not None:
                    return cached
            return plugin.create(source, options)
    raise StitchError(
        f"No decoder plugin registered for format '{fmt}'. "
        f"Available: {[p.format for p in plugins]}"
    )


def create_decoders_from_iterable(
    inputs: Iterable[Any],
    options: DecoderOptions | None = None,
    plugins: Sequence[DecoderPlugin] | None = None,
) -> list:
    """Alias accepting sync/async-style iterables (reference:
    createDecodersFromIterable, decoder-factory.ts:266-283)."""
    return create_decoders(list(inputs), options, plugins)


def _dedupe_key(obj: Any) -> tuple | None:
    """Construction-dedupe key: inputs that denote the same immutable
    source (equal path strings, or the very same bytes object) can share
    one probe via ``clone_fresh``. Mutable buffer types, wrappers, dicts,
    arrays and decoders are never deduped."""
    if isinstance(obj, (str, os.PathLike)):
        return ("path", str(obj))
    if isinstance(obj, bytes):
        # When the opt-in input cache is on, repeated buffers already
        # share a full decode-once pipeline — stronger than probe-once;
        # don't shadow it.
        from .input_cache import input_cache_enabled

        if input_cache_enabled():
            return None
        return ("buf", id(obj))
    return None


def _clone_of(first: Any):
    clone = getattr(first, "clone_fresh", None)
    return clone() if clone is not None else None


def _auto_cache_budget() -> float:
    """Per-create_decoders budget (bytes) for automatic decode-once
    sharing of repeated inputs. The reference ships the same feature as
    an unbounded opt-in (png-input-adapter.ts:34-148) and its own memory
    tests enable it for tiled scenarios (memory.test.ts:33-35); here
    repeated small inputs share one producer by default, bounded so big
    tiles never silently trade the streaming memory posture for speed.
    STITCH_TPU_AUTO_CACHE_MB=0 disables."""
    try:
        return float(os.environ.get("STITCH_TPU_AUTO_CACHE_MB", "64")) * 1e6
    except ValueError:
        return 64e6


def _try_share_entry(dec: Any, input_obj: Any, budget_left: list):
    """Wrap ``dec`` as the producer of a shared decode-once entry if it
    is a safe producer and its decoded size fits the remaining budget.
    Returns the entry or None (caller keeps the plain decoder)."""
    if not getattr(dec, "cache_shareable", False):
        return None
    try:
        hdr = dec.get_header()
        est = (
            hdr.width * hdr.height * (hdr.channels or 4)
            * max(8, hdr.bit_depth or 8) // 8
        )
    except Exception:
        return None  # header errors surface on the normal per-input path
    if est > budget_left[0]:
        return None
    # Tiny PNG tiles take the batched group-decode path instead (one
    # defilter + one convert per same-signature GROUP beats per-unique
    # cached decodes there: pngsuite measured 9.3 vs 7.5 MP/s); the
    # cutoff mirrors group_decode.MAX_TILE_PIXELS. JPEG/HEIC tiles have
    # no group path, so they share at any size within budget.
    if (getattr(dec, "format", "") == "png"
            and hdr.width * hdr.height <= 128 * 128):
        return None
    budget_left[0] -= est
    from .input_cache import _CacheEntry

    return _CacheEntry(input_obj, lambda d=dec: d)


def create_decoders(
    inputs: Iterable[Any],
    options: DecoderOptions | None = None,
    plugins: Sequence[DecoderPlugin] | None = None,
    pool=None,
) -> list:
    """Build decoders for every input (reference: createDecoders /
    createDecodersFromIterable, decoder-factory.ts:216-283).

    Repeated inputs (same path, or the same bytes object — tiled
    mega-images reuse a handful of sources) are probed once: later
    occurrences clone the first decoder's immutable parsed structure
    (``PngDecoder.clone_fresh``); anything non-clonable falls back to
    normal construction, so error surfacing points are unchanged.

    ``pool``: optional ``ThreadPoolExecutor`` — construction (magic-byte
    probe, small-file slurp, header-adjacent IO) runs concurrently across
    inputs, matching the reference's ``Promise.all`` fan-out
    (decoder-factory.ts:222). Order is preserved; on any failure every
    decoder that WAS built is closed before the first error re-raises."""
    inputs = list(inputs)
    keys = [_dedupe_key(obj) for obj in inputs]
    counts: dict = {}
    for k in keys:
        if k is not None:
            counts[k] = counts.get(k, 0) + 1
    budget_left = [_auto_cache_budget()]
    shared: dict = {}  # key -> _CacheEntry (decode-once producers)

    def consumer_of(entry):
        from .input_cache import CachedDecoder

        return CachedDecoder(entry)

    if pool is not None and len(inputs) > 1:
        futures: dict = {}
        pkeys = []
        for idx, (key, obj) in enumerate(zip(keys, inputs)):
            kk = key if key is not None else ("uniq", idx)
            pkeys.append(kk)
            if kk not in futures:
                futures[kk] = pool.submit(create_decoder, obj, options, plugins)
        created: list = []
        first_err: Exception | None = None
        seen: set = set()
        for kk, key, obj in zip(pkeys, keys, inputs):
            try:
                base = futures[kk].result()
            except Exception as exc:  # noqa: BLE001 - collected, re-raised
                if first_err is None:
                    first_err = exc
                continue
            if kk in shared:
                created.append(consumer_of(shared[kk]))
                continue
            if kk not in seen:
                seen.add(kk)
                if key is not None and counts.get(key, 0) > 1:
                    entry = _try_share_entry(base, obj, budget_left)
                    if entry is not None:
                        shared[kk] = entry
                        created.append(consumer_of(entry))
                        continue
                created.append(base)
                continue
            dec = _clone_of(base)
            if dec is None:
                try:
                    dec = create_decoder(obj, options, plugins)
                except Exception as exc:  # noqa: BLE001
                    if first_err is None:
                        first_err = exc
                    continue
            created.append(dec)
        if first_err is not None:
            for d in created:
                try:
                    d.close()
                except Exception:
                    pass
            raise first_err
        return created
    created = []
    by_key: dict = {}
    try:
        for key, input_obj in zip(keys, inputs):
            if key is not None and key in shared:
                created.append(consumer_of(shared[key]))
                continue
            dec = None
            if key is not None and key in by_key:
                dec = _clone_of(by_key[key])
            if dec is None:
                dec = create_decoder(input_obj, options, plugins)
                if key is not None and key not in by_key:
                    by_key[key] = dec
                    if counts.get(key, 0) > 1:
                        entry = _try_share_entry(dec, input_obj, budget_left)
                        if entry is not None:
                            shared[key] = entry
                            created.append(consumer_of(entry))
                            continue
            created.append(dec)
    except Exception:
        for d in created:
            try:
                d.close()
            except Exception:
                pass
        raise
    return created
