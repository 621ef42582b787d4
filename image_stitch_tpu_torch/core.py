"""The streaming orchestrator (L6) — band-at-a-time canvas assembly, with
the per-band device work in torch.

A copy of ``image_stitch_tpu/core.py`` whose encode, positioned
compositing and JPEG-tile decode stages run on a torch ``device``: each
assembled band goes to a ``TorchStreamingJpegEncoder`` or, for PNG output,
to ``TorchBackend``'s filter select; positioned 8-bit bands with alpha
blending composite on the device (``DeviceCompositor``) and go to either
encoder as tensors. For JPEG output, grid bands tiled by JPEG inputs are
decoded on the device (``codecs/jpeg/device_decoder.DeviceTileBands``:
host Huffman once, the pixel math per band there) and handed to the
encoder without leaving it.

``backend="numpy"`` (or "oracle") is the host tier, as in the JAX package:
no device is resolved and no tensor made; bands composite on the host
(``ops.pixel.composite_band``), JPEG tiles decode on the host, and the
bands go to the host ``StreamingJpegEncoder`` or ``ops.backend.
NumpyBackend``. "torch" (the default), "jax" and "tpu" run on ``device``.
"auto" is the JAX package's policy (``ops.backend.resolve_backend_name``),
resolved once a call from the canvas's pixels, as soon as the output
header is known; every later site reads that one answer, and the device is
resolved only if it is "torch".

``mesh`` (an int or a ``parallel.mesh.Mesh``) sends the band programs to
the mesh whatever ``backend`` says, as in the JAX package: the PNG filter,
the JPEG restart groups and the positioned compositor run on its shards,
each band's rows split by ``parallel.mesh.row_slabs``; JPEG tiles decode on
its first device.

Counterpart of the reference's ``CoreStreamingConcatenator``
(src/image-concat-core.ts:279-1473), redesigned TPU-first: where the
reference pulls one scanline per image per output row through per-pixel JS
loops (generateFilteredScanlines, :389-549), this engine assembles whole
*row bands* — (band_height, W, 4) canvases — with vectorized conversion,
placement and compositing, then runs PNG filter-selection or JPEG DCT over
the full band on the accelerator and streams encoded bytes from the host.

The memory contract is the reference's O(canvas_width) guarantee with a
constant band factor: peak live pixels = O(W * band_height), independent of
canvas height (reference contract: src/image-concat-core.ts:263-277).

Two-pass structure preserved (stream(): pass 1 headers, pass 2 pixels,
reference :927-1003), including:
- grid/positioned mode split + mixing validation (:951-955)
- common format: RGBA, 16-bit iff any input 16-bit; JPEG forces 8-bit
  (:1022-1027, pixel-ops.ts:293-307)
- per-input progress callback firing as each input's rows are exhausted
  (:1401-1428)
- dimension-mismatch diagnostics naming input/row/column (:429-474)
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Iterator, Mapping, Sequence

import numpy as np
import torch

from .codecs.factory import (
    create_decoders,
    extract_positions,
    has_positioned_images,
    validate_positioned_inputs,
)
from .codecs.png.writer import create_idat, create_iend, create_ihdr, serialize_chunk
from .codecs.jpeg.device_decoder import device_tile_bands
from .codecs.jpeg.encoder import StreamingJpegEncoder, TorchStreamingJpegEncoder
from .codecs.registry import get_default_decoder_plugins
from .errors import StitchError, format_pixels
from .io.deflate import StreamingDeflator
from .layout.grid import GridLayout, calculate_layout
from .layout.positioned import (
    build_band_plan,
    calculate_canvas_size,
    clip_images_to_canvas,
)
from .ops.backend import get_backend, resolve_backend_name
from .ops.composite_device import DeviceCompositor
from .ops.counters import EncodeCounters
from .ops.device import TorchBackend
from .ops.pixel import (
    background_pixel,
    composite_band,
    convert_band,
    determine_common_format,
)
from .ops.resolve import resolve_device
from .parallel.mesh import Mesh, ShardedBand, make_mesh
from .types import (
    ConcatOptions,
    ImageHeader,
    PngHeader,
    image_header_to_png_header,
)
from .utils import PNG_SIGNATURE, scanline_byte_length
from .utils.observability import JobPool, PipelineStats, next_job, profiled, span, traced


def _to_host(band) -> np.ndarray:
    if isinstance(band, (torch.Tensor, ShardedBand)):
        return band.cpu().numpy()
    return band


class ProgressTracker:
    """Fires on_progress(completed, total) as inputs finish streaming
    (reference: createProgressTracker, image-concat-core.ts:1401-1428)."""

    def __init__(self, headers: Sequence[PngHeader], callback: Callable[[int, int], None]):
        import threading

        self.remaining = [h.height for h in headers]
        self.total = len(headers)
        self.completed = 0
        self.callback = callback
        # host_threads decode workers call consumed() concurrently; the
        # read-modify-write on remaining/completed needs the lock.
        self._lock = threading.Lock()
        # Callbacks deliver under their own lock, in completed order, so
        # user code never sees (2, total) before (1, total) and need not be
        # thread-safe even with host_threads > 1.
        self._cb_lock = threading.Lock()
        self._cb_next = 0  # next `completed` value to deliver
        # Reentrancy guard: a callback that drives the tracker again (e.g.
        # pulls more rows -> consumed() -> _deliver()) must not re-enter
        # delivery on its own thread — the non-reentrant _cb_lock would
        # self-deadlock. The outer delivery loop re-reads `completed` after
        # each callback, so skipped reentrant deliveries are picked up.
        self._delivering = threading.local()
        # Zero-height inputs complete immediately (reference :1417-1425).
        for i, h in enumerate(headers):
            if h.height == 0:
                self.completed += 1
        if self.completed:
            self.callback(self.completed, self.total)
        self._cb_next = self.completed

    def consumed(self, image_idx: int, n_rows: int) -> None:
        with self._lock:
            if self.remaining[image_idx] <= 0:
                return
            self.remaining[image_idx] -= n_rows
            if self.remaining[image_idx] > 0:
                return
            self.remaining[image_idx] = 0
            self.completed += 1
        self._deliver()

    def _deliver(self) -> None:
        """Deliver pending callbacks serially and in increasing order."""
        if getattr(self._delivering, "active", False):
            return  # reentrant from our own callback; outer loop re-checks
        self._delivering.active = True
        try:
            while True:
                with self._cb_lock:
                    with self._lock:
                        if self._cb_next >= self.completed:
                            return
                        self._cb_next += 1
                        value = self._cb_next
                    self.callback(value, self.total)
        finally:
            self._delivering.active = False


class RowSource:
    """Streams converted RGBA rows from one decoder with band buffering.

    Pulls raw bands from the decoder, validates their byte width (the
    reference's per-row checks, image-concat-core.ts:437-447), converts to
    the common RGBA format, and serves arbitrary row ranges to the canvas
    assembler.
    """

    def __init__(
        self,
        image_idx: int,
        decoder,
        header: PngHeader,
        metadata: Mapping[str, Any],
        target_bit_depth: int,
        band_height: int,
        progress: ProgressTracker | None = None,
        group_provider=None,
    ):
        self.image_idx = image_idx
        self.header = header
        self._meta = metadata
        self._target_depth = target_bit_depth
        # Batched small-tile decode (codecs/png/group_decode): a lazy
        # provider for this tile's fully converted array. The normal
        # band iterator below is created but NOT started (generators run
        # on first next()), so a failed group decode falls back to it
        # with per-input error attribution intact.
        self._group_provider = group_provider
        self.decoder = decoder
        self._span_name = f"decode.{getattr(decoder, 'format', 'input')}"
        self._band_height = band_height
        # The band iterator is created lazily for grouped tiles (the
        # group path normally never touches it); generators only run on
        # first next(), so the fallback semantics are identical.
        self._iter = None
        if group_provider is None:
            self._make_iter()
        # Decoders that guarantee each yielded band is a fresh (or never
        # mutated) array set ``bands_are_owned``; for those the RGBA8
        # identity conversion may alias the band instead of copying.
        # Injected custom decoders default to the safe copying path — they
        # may legally reuse a scratch buffer between yields.
        self._bands_owned = bool(getattr(decoder, "bands_are_owned", False))
        self._expected_row_bytes = scanline_byte_length(
            header.width, header.bit_depth, header.color_type
        )
        self._buf: np.ndarray | None = None  # converted rows not yet served
        self.rows_served = 0
        self._progress = progress
        self._context: tuple[int, int] | None = None  # (grid_row, grid_col) 1-based

    def _make_iter(self) -> None:
        decoder, band_height = self.decoder, self._band_height
        self._iter = decoder.bands(band_height) if hasattr(decoder, "bands") else None
        if self._iter is None:
            self._iter = _bands_from_rows(decoder.scanlines(), band_height)

    def set_context(self, grid_row: int, grid_col: int) -> None:
        self._context = (grid_row, grid_col)

    def _where(self) -> str:
        if self._context:
            return (
                f"while assembling row {self._context[0]}, column {self._context[1]}"
            )
        return f"at source row {self.rows_served + 1}"

    def _pull(self) -> bool:
        with span(self._span_name):
            return self._pull_rows()

    def _pull_rows(self) -> bool:
        if self._group_provider is not None:
            provider, self._group_provider = self._group_provider, None
            converted = provider()
            if converted is not None:
                self._buf = (
                    converted
                    if self._buf is None
                    else np.vstack([self._buf, converted])
                )
                return True
            # Group decode failed: fall back to the per-tile path (the
            # group never touches decoder state, so it starts clean and
            # re-raises with proper per-input error attribution).
        if self._iter is None:
            self._make_iter()
        try:
            raw = next(self._iter)
        except StopIteration:
            return False
        except StitchError as exc:
            # Surface decoder failures with input context (reference error
            # style: image-concat-core.ts:429-447).
            raise StitchError(
                f"decode failed for input #{self.image_idx + 1} {self._where()}", exc
            ) from exc
        raw = np.atleast_2d(np.asarray(raw, dtype=np.uint8))
        if raw.shape[1] != self._expected_row_bytes:
            bits_per_pixel = (
                self.header.bit_depth
                * (self._expected_row_bytes * 8 // max(1, self.header.width * self.header.bit_depth))
            )
            actual_w = (
                raw.shape[1] * 8 * self.header.width / (self._expected_row_bytes * 8)
                if self._expected_row_bytes
                else 0
            )
            raise StitchError(
                f"dimension mismatch for input #{self.image_idx + 1} {self._where()}. "
                f"Expected {format_pixels(self.header.width)} wide scanline "
                f"({self._expected_row_bytes} raw bytes) but decoder produced "
                f"{format_pixels(actual_w)} ({raw.shape[1]} raw bytes)."
            )
        try:
            # copy=False (owned bands only): ``raw`` is a freshly
            # defiltered band and every take() consumer copies into a
            # canvas — the RGBA8 identity conversion can be a view.
            converted = convert_band(
                raw,
                self.header.width,
                self.header.bit_depth,
                self.header.color_type,
                self._target_depth,
                palette=self._meta.get("palette"),
                trns=self._meta.get("trns"),
                copy=not self._bands_owned,
            )
        except StitchError:
            raise
        except Exception as exc:  # pragma: no cover - defensive
            raise StitchError(
                f"unable to normalize input #{self.image_idx + 1} {self._where()}", exc
            ) from exc
        self._buf = converted if self._buf is None else np.vstack([self._buf, converted])
        return True

    def take(self, n: int) -> np.ndarray:
        """Return the next ``n`` converted rows as (n, W, 4)."""
        while self._buf is None or self._buf.shape[0] < n:
            if not self._pull():
                produced = self.rows_served + (0 if self._buf is None else self._buf.shape[0])
                raise StitchError(
                    f"dimension mismatch for input #{self.image_idx + 1} {self._where()}. "
                    f"Expected {format_pixels(self.header.height)} tall image but "
                    f"decoder ended after {format_pixels(produced)}."
                )
        out = self._buf[:n]
        self._buf = self._buf[n:] if self._buf.shape[0] > n else None
        self.rows_served += n
        if self.rows_served >= self.header.height and self._buf is None:
            # The decoder generator is suspended just after its last yield;
            # close it now so its frame (inflate state, scratch, pending
            # input) is released immediately instead of at stream end — with
            # many inputs that retained ~0.5 MB per finished tile.
            close = getattr(self._iter, "close", None)
            if close is not None:
                close()
        if self._progress is not None:
            self._progress.consumed(self.image_idx, n)
        return out

    def skip(self, n: int) -> None:
        """Discard ``n`` rows (positioned-mode top clipping,
        reference: image-concat-core.ts:592-599)."""
        if n <= 0:
            return
        self.take(n)

    def note_rows_served(self, n: int) -> None:
        """Account rows served OUTSIDE take() (the device decode path
        reads by random access): progress and completion bookkeeping."""
        self.rows_served += n
        if self._progress is not None:
            self._progress.consumed(self.image_idx, n)


def _bands_from_rows(rows: Iterator[np.ndarray], band_height: int):
    buf: list[np.ndarray] = []
    for row in rows:
        buf.append(np.asarray(row, dtype=np.uint8))
        if len(buf) == band_height:
            yield np.stack(buf)
            buf = []
    if buf:
        yield np.stack(buf)


class TorchStreamingConcatenator:
    """Band-streaming concatenator with the band work on a torch device, or
    on the host tier under ``backend="numpy"`` (reference:
    CoreStreamingConcatenator, image-concat-core.ts:279).

    A ``backend`` other than "auto", "torch", "jax", "tpu", "numpy" or
    "oracle" raises. The host tier leaves ``device`` unread (``self.device``
    is None); "auto" leaves it unread until a call resolves the policy to
    "torch" (``_resolve_backend``). ``mesh``: an int makes
    ``make_mesh(n, device=...)`` (virtual shards on the CPU); a ``Mesh``
    must be of ``device``'s kind. Either takes the band programs whatever
    ``backend`` says, and ``self.device`` is the mesh's first device."""

    def __init__(self, options: ConcatOptions | Mapping[str, Any], device="cuda",
                 counters: EncodeCounters | None = None):
        self.options = ConcatOptions.from_any(options)
        # "auto" waits for the canvas's size; any other name resolves now.
        name = self.options.backend
        self.backend = name if name == "auto" else resolve_backend_name(name)
        self.options.validate()
        # Live telemetry for the run (band/pixel/byte counters; a traced
        # run's spans). SURVEY §5: first-class here, absent in the reference.
        self.stats = PipelineStats()
        self._pool = None  # host_threads decode workers (lazy)
        self._deflate_pool = None  # the PNG deflate's worker at host_threads 1 (lazy)
        self._device_arg = device
        self.mesh = self._resolved_mesh(device)
        if self.mesh is not None:
            self.device = self.mesh.flat()[0]
        else:
            self.device = resolve_device(device) if self.backend == "torch" else None
        self.counters = counters if counters is not None else EncodeCounters()

    def _resolve_backend(self, out_header: PngHeader) -> None:
        """Resolve ``backend="auto"`` for this call from the output's pixels
        (the JAX package resolves it with the same count at each site), and
        the device only where the answer is "torch". A mesh takes the band
        programs whatever ``backend`` says, so it is not asked."""
        if self.options.backend != "auto" or self.mesh is not None:
            return
        self.backend = resolve_backend_name(
            "auto", out_header.width * out_header.height, self._device_arg)
        self.device = resolve_device(self._device_arg) if self.backend == "torch" else None

    def _resolved_mesh(self, device) -> Mesh | None:
        """``options.mesh`` (Mesh | int | None) as a Mesh on ``device``'s
        kind, or None."""
        m = self.options.mesh
        if m is None:
            return None
        kind = resolve_device(device).type
        if isinstance(m, Mesh):
            if m.device_type != kind:
                raise StitchError(f"mesh on {m.device_type} devices, but device={str(device)!r}")
            return m
        if isinstance(m, bool) or not isinstance(m, int):
            raise StitchError(f"mesh must be an int or a Mesh, got {type(m).__name__}")
        return make_mesh(m, device=kind)

    def _host_pool(self):
        """ThreadPoolExecutor for parallel per-input band pulls, or None for
        serial (host_threads <= 1). The hot per-tile work — native inflate,
        SIMD defilter, convert — releases the GIL inside ctypes/numpy calls,
        so separate inputs decode on separate cores. TPU-native extension:
        the reference is single-threaded Node (SURVEY §2; a worker-pool
        decode tier has no analog there)."""
        n = self.options.resolved_host_threads()
        if n <= 1:
            return None
        if self._pool is None:
            self._pool = JobPool(max_workers=n, thread_name_prefix="stitch-host")
        return self._pool

    def _deflate_worker(self):
        """The pool of the PNG writer's deflate: the host pool when there is
        one, else one compression worker of this concatenator's own, which
        compresses a sync-flush batch while this thread decodes and filters
        the next band (as the reference's runtime zlib compresses off its
        single JS thread). Made at the first PNG job, its thread at the
        first batch handed to it; it serves every later job, and
        ``close()`` ends it."""
        pool = self._host_pool()
        if pool is not None:
            return pool
        if self._deflate_pool is None:
            self._deflate_pool = JobPool(max_workers=1, thread_name_prefix="stitch-deflate")
        return self._deflate_pool

    def close(self) -> None:
        """End the deflate worker's thread, once its batch in flight is done.
        A later job makes a new one."""
        if self._deflate_pool is not None:
            self._deflate_pool.shutdown(wait=True)
            self._deflate_pool = None

    # ------------------------------------------------------------------ #

    def _check_canvas_dims(self, width: int, height: int) -> None:
        """Reject canvases beyond max_canvas_dim per axis (0 = unlimited).

        Headers are untrusted input: a corrupt IHDR declaring a huge width
        would otherwise drive a clean but machine-killing band allocation
        (fuzz-found MemoryError at ~2^31-px widths) — fail with a clear
        StitchError before any pixel memory is touched."""
        limit = self.options.max_canvas_dim
        if limit and (width > limit or height > limit):
            raise StitchError(
                f"Canvas {width}x{height} exceeds maxCanvasDim={limit}; "
                "raise the maxCanvasDim option if this is intentional"
            )

    def stream(self) -> Iterator[bytes]:
        """Two-pass streaming generator (reference: stream(),
        image-concat-core.ts:927-1003). Traced when a torch profiler records
        at the call (utils/observability.py)."""
        start = time.perf_counter_ns()
        job = next_job()
        if not profiled():
            return self._stream()
        self.stats.job = job
        return traced(job, self._stream(), start)

    def _stream(self) -> Iterator[bytes]:
        jpeg = self.options.output_format == "jpeg"
        with self._job() as (bands, out_header):
            encode = self._encode_jpeg if jpeg else self._encode_png
            for chunk in encode(bands, out_header):
                self.stats.record_output(len(chunk))
                yield chunk

    def stream_bands(self) -> Iterator[np.ndarray]:
        """Yield the assembled (h, W, 4) canvas bands as HOST arrays, no
        encode stage — the array-native output path (the reference's
        concatCanvases renders onto a canvas without an encode round trip,
        image-concat-browser.ts:287-323). Same decode/assembly/compositing
        pipeline and exactness contracts as stream(); dtype is uint8 or
        uint16 per the common input format."""
        with self._job() as (bands, _out_header):
            for band in bands:
                # A band decoded or blended on the device is a tensor there;
                # materialize on host.
                yield _to_host(band)

    @contextlib.contextmanager
    def _job(self) -> Iterator[tuple[Iterator[np.ndarray | torch.Tensor], PngHeader]]:
        """One call's set-up and tear-down, for stream() and stream_bands():
        the inputs checked, the decoders made and their headers read, then
        the grid or positioned band pipeline, given as (bands, output
        header). On exit the host pool shuts down and every decoder closes."""
        opts = self.options
        inputs = list(opts.inputs)
        if len(inputs) == 0:
            raise StitchError("At least one input image is required")

        positioned_mode = has_positioned_images(inputs)
        if positioned_mode:
            validate_positioned_inputs(inputs)

        plugins = (
            list(opts.decoders) if opts.decoders is not None else get_default_decoder_plugins()
        )
        decoders = create_decoders(
            inputs, opts.decoder_options, plugins, pool=self._host_pool()
        )
        try:
            image_headers: list[ImageHeader] = [d.get_header() for d in decoders]
            headers = [image_header_to_png_header(h) for h in image_headers]
            target_depth, _target_ct = determine_common_format(headers)
            if positioned_mode:
                yield self._positioned_band_pipeline(
                    inputs, decoders, image_headers, headers, target_depth
                )
            else:
                yield self._grid_band_pipeline(
                    decoders, image_headers, headers, target_depth
                )
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None
            for d in decoders:
                try:
                    d.close()
                except Exception:
                    pass

    # ---------------------------- grid mode --------------------------- #

    def _grid_band_pipeline(
        self,
        decoders: Sequence,
        image_headers: Sequence[ImageHeader],
        headers: Sequence[PngHeader],
        target_depth: int,
    ) -> tuple[Iterator[np.ndarray], PngHeader]:
        """Shared grid setup: layout, sources, band assembly (no encode)."""
        opts = self.options
        layout = opts.layout
        if not (layout.columns or layout.rows or layout.width or layout.height):
            raise StitchError("Grid mode requires layout: columns, rows, width, or height")

        grid_layout = calculate_layout(headers, layout)
        self._check_canvas_dims(
            grid_layout.total_width, grid_layout.total_height
        )
        final_depth = 8 if opts.output_format == "jpeg" else target_depth

        out_header = PngHeader(
            width=grid_layout.total_width,
            height=grid_layout.total_height,
            bit_depth=final_depth,
            color_type=6,
        )
        self._resolve_backend(out_header)

        progress = (
            ProgressTracker(headers, opts.on_progress) if opts.on_progress else None
        )
        # Batched small-tile decode: many-tiny-tile grids (pngsuite-class
        # sweeps) group same-signature tiles through one defilter + one
        # convert call, deleting the dominant per-tile numpy fixed costs.
        from .codecs.png.group_decode import plan_group_providers

        group_providers = plan_group_providers(
            decoders,
            headers,
            [image_headers[i].metadata or {} for i in range(len(decoders))],
            final_depth,
        )
        sources = [
            RowSource(
                i,
                decoders[i],
                headers[i],
                image_headers[i].metadata or {},
                final_depth,
                opts.band_height,
                progress,
                group_provider=group_providers.get(i),
            )
            for i in range(len(decoders))
        ]
        return self._grid_canvas_bands(grid_layout, sources, out_header), out_header

    def _grid_canvas_bands(
        self,
        gl: GridLayout,
        sources: Sequence[RowSource],
        out_header: PngHeader,
    ) -> Iterator[np.ndarray | torch.Tensor]:
        """Assemble output bands for the grid (reference hot loop:
        generateFilteredScanlines / generateRawScanlines,
        image-concat-core.ts:389-549 / :691-836 — here whole bands at once).
        A band decoded on the device is yielded as a tensor there."""
        opts = self.options
        bg = background_pixel(out_header.bit_depth, opts.background_color)
        dtype = np.uint16 if out_header.bit_depth == 16 else np.uint8
        band_h = opts.band_height
        width = out_header.width

        # Precompute each placed image's (y0, x0) on the canvas and its grid
        # position for diagnostics.
        placements = []  # (image_idx, y0, x0, grid_row, grid_col)
        y_cursor = 0
        for r, row in enumerate(gl.grid):
            x_cursor = 0
            for c, image_idx in enumerate(row):
                col_w = gl.col_widths[r][c]
                if image_idx >= 0:
                    placements.append((image_idx, y_cursor, x_cursor, r + 1, c + 1))
                    sources[image_idx].set_context(r + 1, c + 1)
                x_cursor += col_w
            y_cursor += gl.row_heights[r]

        # Rows of the canvas fully covered by placements skip the background
        # fill (every cell image spans its full cell): in uniform grids that
        # is every row, saving a full canvas-sized memset per band.
        x_accum = np.zeros(out_header.height, dtype=np.int64)
        for image_idx, y0, x0, _r, _c in placements:
            hh = sources[image_idx].header.height
            ww = sources[image_idx].header.width
            x_accum[y0 : y0 + hh] += ww
        covered_rows = x_accum >= width

        from .utils import trim_malloc  # noqa: F401 (used below)

        total_h = out_header.height

        def band_active(band_y0: int, h: int):
            active = []  # (image_idx, x0, img_w, seg_y0, seg_y1)
            for image_idx, y0, x0, _r, _c in placements:
                img_h = sources[image_idx].header.height
                img_w = sources[image_idx].header.width
                seg_y0 = max(band_y0, y0)
                seg_y1 = min(band_y0 + h, y0 + img_h)
                if seg_y1 > seg_y0:
                    active.append((image_idx, x0, img_w, seg_y0, seg_y1))
            return active

        band_specs = [
            (band_y0, min(band_h, total_h - band_y0))
            for band_y0 in range(0, total_h, band_h)
        ]
        pool = self._host_pool()

        # JPEG tiles that the device decode serves (``DeviceTileBands``): a
        # band fully tiled by them is decoded there whole and yielded as a
        # tensor; in a band assembled here their rows come from it too,
        # never from take(). None: every tile is read here.
        tiles = device_tile_bands(
            self.device, opts.output_format, out_header.bit_depth, width,
            [src.decoder for src in sources], [src.header for src in sources],
            {p[0]: p[1] for p in placements}, self.counters,
            lambda image_idx, n: sources[image_idx].note_rows_served(n))

        def on_device(image_idx: int) -> bool:
            return tiles is not None and tiles.serves(image_idx)

        def make_plan(band_y0: int, h: int):
            """("device", tile_rows, None) when the device decodes the band
            whole (``DeviceTileBands.plan``), else ("host", active, futs)
            with pool futures for the take()-served segments only."""
            active = band_active(band_y0, h)
            tile_rows = tiles.plan(band_y0, h, active) if tiles is not None else None
            if tile_rows is not None:
                return ("device", tile_rows, None)
            futs = None
            if pool is not None:
                # One pull per take()-served input (each input owns one
                # grid cell, so takes touch disjoint sources); placement
                # order keeps bytes and first-error identical to serial.
                futs = [
                    None if on_device(image_idx)
                    else pool.submit(sources[image_idx].take, seg_y1 - seg_y0)
                    for image_idx, _x0, _w, seg_y0, seg_y1 in active
                ]
            return ("host", active, futs)

        pending = None  # lookahead: band N+1 decodes while N encodes
        for band_idx, (band_y0, h) in enumerate(band_specs):
            # Only band 0 makes its plan here; every later one was made ahead.
            plan = pending if pending is not None else make_plan(band_y0, h)
            pending = None
            trim = band_idx and band_idx % 16 == 0  # keep RSS at the live set
            if plan[0] == "device":
                if trim:
                    trim_malloc()
                band_dev = tiles.band(band_y0, h, plan[1])
                if band_idx + 1 < len(band_specs):
                    pending = make_plan(*band_specs[band_idx + 1])
                yield band_dev
                continue
            with span("assemble"):
                if trim:
                    trim_malloc()
                active, futs = plan[1], plan[2]
                canvas = np.empty((h, width, 4), dtype=dtype)
                if not covered_rows[band_y0 : band_y0 + h].all():
                    canvas[:] = bg
                for i, (image_idx, x0, img_w, seg_y0, seg_y1) in enumerate(active):
                    if on_device(image_idx):
                        rows = tiles.rows(image_idx, seg_y0, seg_y1)
                    elif futs is not None:
                        rows = futs[i].result()
                    else:
                        rows = sources[image_idx].take(seg_y1 - seg_y0)
                    canvas[seg_y0 - band_y0 : seg_y1 - band_y0, x0 : x0 + img_w] = rows
                # Submit the NEXT band's pulls before yielding: the consumer
                # encodes this band (native entropy/deflate release the GIL)
                # while the workers decode ahead. Bounded lookahead: one
                # band of rows per source.
                if band_idx + 1 < len(band_specs):
                    pending = make_plan(*band_specs[band_idx + 1])
            yield canvas
        if tiles is not None:
            tiles.close()

    # -------------------------- positioned mode ------------------------ #

    def _positioned_band_pipeline(
        self,
        inputs: Sequence,
        decoders: Sequence,
        image_headers: Sequence[ImageHeader],
        headers: Sequence[PngHeader],
        target_depth: int,
    ) -> tuple[Iterator[np.ndarray], PngHeader]:
        """Shared positioned setup: canvas size, clipping, sources, band
        compositing (no encode)."""
        opts = self.options
        positions_raw = extract_positions(inputs)
        positions = []
        for pos in positions_raw:
            if pos is None:
                raise StitchError("Internal error: non-positioned image in positioned mode")
            positions.append(pos)

        canvas_w, canvas_h = calculate_canvas_size(
            [
                {
                    "x": p["x"],
                    "y": p["y"],
                    "width": headers[i].width,
                    "height": headers[i].height,
                }
                for i, p in enumerate(positions)
            ],
            opts.layout.width,
            opts.layout.height,
        )
        self._check_canvas_dims(canvas_w, canvas_h)
        clipped, placed = clip_images_to_canvas(positions, headers, canvas_w, canvas_h)
        clip_by_idx = {c.image_idx: c for c in clipped}

        out_format = opts.output_format
        final_depth = 8 if out_format == "jpeg" else target_depth
        out_header = PngHeader(
            width=canvas_w, height=canvas_h, bit_depth=final_depth, color_type=6
        )
        self._resolve_backend(out_header)

        progress = (
            ProgressTracker(headers, opts.on_progress) if opts.on_progress else None
        )
        sources = [
            RowSource(
                i,
                decoders[i],
                headers[i],
                image_headers[i].metadata or {},
                final_depth,
                opts.band_height,
                progress,
            )
            for i in range(len(decoders))
        ]
        bands = self._positioned_canvas_bands(
            placed, clip_by_idx, sources, out_header
        )
        return bands, out_header

    def _positioned_canvas_bands(
        self,
        placed,
        clip_by_idx,
        sources: Sequence[RowSource],
        out_header: PngHeader,
    ) -> Iterator[np.ndarray | torch.Tensor]:
        """Assemble positioned-mode bands back-to-front
        (reference: generatePositionedScanlines, image-concat-core.ts:551-686;
        z-order per band instead of per scanline)."""
        opts = self.options
        bg = background_pixel(out_header.bit_depth, opts.background_color)
        dtype = np.uint16 if out_header.bit_depth == 16 else np.uint8
        band_h = opts.band_height
        blend = opts.enable_alpha_blending is not False

        # Device compositor (one kernel launch per band) for 8-bit alpha
        # blending; exact-tie bands replay through the host float64 oracle
        # (ops/composite_device.py). The host tier blends every band with
        # that oracle.
        compositor = None
        if blend and dtype == np.uint8 and self.device is not None:
            # Under a mesh, slabs of the consumer's alignment: whole
            # restart groups for JPEG, rows for PNG.
            align = 1
            if opts.output_format == "jpeg":
                align = 16 if opts.jpeg_sampling == "420" else 8
                align *= max(1, opts.jpeg_restart_interval_rows)
            compositor = DeviceCompositor(self.device, self.counters, mesh=self.mesh,
                                          align=align)

        plans = build_band_plan(placed, out_header.height, band_h)
        # Per-image caches: positioned images can span bands; rows are read
        # once and in order (sources are streams). Because z-order within a
        # band can interleave images arbitrarily but rows are consumed
        # band-by-band monotonically per image, streaming works: each band
        # touches a contiguous, increasing row range per image.
        from .utils import trim_malloc

        for band_idx, segs in enumerate(plans):
            if band_idx and band_idx % 16 == 0:
                trim_malloc()
            band_y0 = band_idx * band_h
            h = min(band_h, out_header.height - band_y0)
            canvas = np.empty((h, out_header.width, 4), dtype=dtype)
            canvas[:] = bg

            def pull_seg(seg) -> tuple[np.ndarray, int, int]:
                src = sources[seg.image_idx]
                clip = clip_by_idx.get(seg.image_idx)
                src_off_x = clip.source_offset_x if clip else 0
                src_off_y = clip.source_offset_y if clip else 0
                # Absolute source rows wanted for this segment.
                want_lo = seg.local_y0 + src_off_y
                want_hi = seg.local_y1 + src_off_y
                if src.rows_served < want_lo:
                    src.skip(want_lo - src.rows_served)
                rows = src.take(want_hi - max(want_lo, src.rows_served))
                seg_w = seg.end_x - seg.start_x
                rows = rows[:, src_off_x : src_off_x + seg_w]
                return (rows, seg.band_y0, seg.start_x)

            seg_rows: list[tuple[np.ndarray, int, int]] = []
            pool = self._host_pool()
            if pool is not None and len(segs) > 1:
                # Pulls parallelize ACROSS images; a given source's pulls
                # must stay ordered (skip/take mutate its row cursor), so
                # each worker owns every segment of one image, in band
                # order. seg_rows is reassembled in the original z-sorted
                # segment order, so composited bytes match serial exactly.
                by_image: dict[int, list[int]] = {}
                for i, seg in enumerate(segs):
                    by_image.setdefault(seg.image_idx, []).append(i)

                def pull_image(indices: list[int]):
                    return [(i, pull_seg(segs[i])) for i in indices]

                futs = [
                    pool.submit(pull_image, indices)
                    for indices in by_image.values()
                ]
                gathered: dict[int, tuple[np.ndarray, int, int]] = {}
                for fut in futs:
                    for i, res in fut.result():
                        gathered[i] = res
                seg_rows = [gathered[i] for i in range(len(segs))]
            else:
                for seg in segs:
                    seg_rows.append(pull_seg(seg))
            if compositor is not None and seg_rows:
                # Device handoff: the blended band stays resident on the
                # device; PNG output filters it there, and _encode_jpeg
                # reads it back for the host strip buffer.
                blended = compositor.composite_band(canvas, seg_rows)
                if blended is not None:
                    yield blended
                    continue
            for rows, seg_y0, start_x in seg_rows:
                composite_band(
                    canvas[seg_y0 : seg_y0 + rows.shape[0]],
                    rows,
                    start_x=start_x,
                    use_alpha_blending=blend,
                )
            yield canvas

    # ----------------------------- encoders ---------------------------- #

    def _encode_png(
        self, bands: Iterator[np.ndarray | torch.Tensor], out_header: PngHeader
    ) -> Iterator[bytes]:
        """The PNG file: signature and IHDR, then each band filter-selected
        on the device (or on the host tier) into the streaming deflator,
        IDAT chunks as they materialize (reference: streamCompressedData,
        image-concat-core.ts:309-383), and IEND."""
        yield PNG_SIGNATURE
        yield serialize_chunk(create_ihdr(out_header))
        host_tier = self.backend == "numpy" and self.mesh is None
        if self.mesh is not None:
            backend = TorchBackend(self.device, self.counters, mesh=self.mesh)
        else:
            backend = get_backend(self.backend, self.device, self.counters)
        chunks: list[bytes] = []
        deflator = StreamingDeflator(
            level=self.options.png_compression_level,
            on_data=chunks.append,
            strategy=self.options.png_compression_strategy,
            pool=self._deflate_worker(),
            # The IDAT stream is always filter residuals: the native tier's
            # filtered-scanline matcher profile (+20% stage at zlib-6-parity
            # size on this class; io/deflate.py) applies under "default".
            content_hint="filtered_png",
            counters=self.counters,
        )

        def idat() -> bytes:
            with span("png.idat") as s:
                chunk = serialize_chunk(create_idat(chunks.pop(0)))
                s.n = len(chunk)
            return chunk

        def emit(pending) -> Iterator[bytes]:
            ftypes, filtered, _last = backend.png_filter_band_wait(pending)
            h = filtered.shape[0]
            interleaved = np.empty((h, 1 + filtered.shape[1]), dtype=np.uint8)
            interleaved[:, 0] = ftypes
            interleaved[:, 1:] = filtered
            deflator.push(interleaved.tobytes())
            while chunks:
                yield idat()

        # One-band lookahead: submit filter-select for band N (device compute
        # + async readback), then deflate band N-1 on the host. The filter
        # carry (previous raw row) is input data that stays on the device,
        # so submission never waits on device results. The host tier's
        # carry is the host row its synchronous filter returns.
        prev_row = None
        pending = None
        for canvas in bands:
            self.stats.record_band(canvas.shape[0], canvas.shape[1])
            if host_tier and isinstance(canvas, torch.Tensor):
                raise StitchError(
                    f"a tensor band on {canvas.device} reached the host PNG "
                    "encoder (backend='numpy'); the host tier takes host arrays only"
                )
            handle = backend.png_filter_band_async(canvas, prev_row)
            if host_tier:
                prev_row = handle[2]
                self.counters.host_tier_bands += 1
            else:
                prev_row = handle.carry
            if pending is not None:
                yield from emit(pending)
            pending = handle
        if pending is not None:
            yield from emit(pending)
        deflator.finish()
        while chunks:
            yield idat()
        yield serialize_chunk(create_iend())

    def _encode_jpeg(
        self, bands: Iterator[np.ndarray | torch.Tensor], out_header: PngHeader
    ) -> Iterator[bytes]:
        """JPEG encode over 8-row MCU strips (reference: streamJpegData,
        image-concat-core.ts:837-925; edge-pixel repetition for the partial
        final strip happens inside the encoder). A band decoded or blended
        on the device goes to the encoder as a tensor, with no read-back.
        The host tier's encoder takes host arrays only."""
        kwargs = dict(
            width=out_header.width,
            height=out_header.height,
            quality=self.options.jpeg_quality,
            sampling=self.options.jpeg_sampling,
            restart_interval_rows=self.options.jpeg_restart_interval_rows,
            counters=self.counters,
        )
        if self.backend == "numpy" and self.mesh is None:
            encoder = StreamingJpegEncoder(**kwargs)
        else:
            encoder = TorchStreamingJpegEncoder(**kwargs, device=self.device, mesh=self.mesh)
        yield from encoder.header()
        for canvas in bands:
            # A rank-2 uint32 band is byte-packed RGBA, which the encoders
            # view as RGBA (as the JAX package's stage takes it); anything
            # else must be 8-bit interleaved.
            packed = canvas.ndim == 2 and canvas.dtype in (np.uint32, torch.uint32)
            if not packed and (canvas.dtype not in (np.uint8, torch.uint8) or canvas.ndim != 3):
                raise StitchError("JPEG encoding requires 8-bit canvas bands")
            self.stats.record_band(canvas.shape[0], canvas.shape[1])
            yield from encoder.encode_band(canvas)
        yield from encoder.finish()


def stream_once(concatenator: TorchStreamingConcatenator) -> Iterator[bytes]:
    """``concatenator.stream()`` for a one-shot call: the concatenator is
    closed when the stream ends, is closed or fails."""
    chunks = concatenator.stream()

    def run() -> Iterator[bytes]:
        try:
            yield from chunks
        finally:
            concatenator.close()

    return run()


def concat_core(options, device="cuda") -> bytes:
    """Collect the full stream (reference: concat core fn,
    image-concat-core.ts:1475-1503)."""
    return b"".join(concat_streaming_core(options, device))


def concat_streaming_core(options, device="cuda") -> Iterator[bytes]:
    """(reference: concatStreaming, image-concat-core.ts:1505-1511)."""
    return stream_once(TorchStreamingConcatenator(options, device))
