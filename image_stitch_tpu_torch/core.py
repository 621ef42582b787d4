"""Band-streaming concatenator whose per-band device work runs in torch.

``TorchStreamingConcatenator`` is the JAX package's
``CoreStreamingConcatenator`` with its device hooks overridden: decoding,
layout and band assembly stay the parent's host code (the ``numpy`` route,
as with the JAX package's numpy backend); each assembled band goes to a
``TorchStreamingJpegEncoder`` or, for PNG output, to ``TorchBackend``'s
filter select on ``device``; positioned 8-bit bands with alpha blending
composite on ``device`` (``DeviceCompositor``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Mapping, Sequence

import numpy as np
import torch

from image_stitch_tpu.codecs.png.writer import (
    create_idat, create_iend, create_ihdr, serialize_chunk,
)
from image_stitch_tpu.core import CoreStreamingConcatenator, RowSource
from image_stitch_tpu.errors import StitchError
from image_stitch_tpu.io.deflate import StreamingDeflator
from image_stitch_tpu.layout.positioned import build_band_plan
from image_stitch_tpu.ops.pixel import background_pixel, composite_band
from image_stitch_tpu.types import ConcatOptions, PngHeader
from image_stitch_tpu.utils import PNG_SIGNATURE, trim_malloc

from .codecs.jpeg.encoder import TorchStreamingJpegEncoder
from .ops.composite_device import DeviceCompositor
from .ops.device import TorchBackend
from .ops.counters import EncodeCounters


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a torch.device; "cuda" without a usable card raises
    instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise StitchError(
            f"device={str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain torch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise StitchError(f"Unsupported device: {device}")
    return dev


def _to_host(band: np.ndarray | torch.Tensor) -> np.ndarray:
    return band.cpu().numpy() if isinstance(band, torch.Tensor) else band


class TorchStreamingConcatenator(CoreStreamingConcatenator):
    """Concatenate to PNG or JPEG with the band work on a torch device.

    ``mesh`` and any ``backend`` other than "auto" or "torch" raise, since
    they name another package's path."""

    def __init__(self, options: ConcatOptions | Mapping[str, Any], device="cuda",
                 counters: EncodeCounters | None = None):
        opts = ConcatOptions.from_any(options)
        if opts.mesh is not None:
            raise StitchError("mesh is not supported by image_stitch_tpu_torch")
        if opts.backend not in ("auto", "torch"):
            raise StitchError(
                f"backend={opts.backend!r} is not a path of image_stitch_tpu_torch; "
                "use 'torch' (or leave it unset)"
            )
        # The inherited host layers take their numpy route; a copy keeps the
        # caller's options unchanged.
        super().__init__(dataclasses.replace(opts, backend="numpy"))
        self.device = resolve_device(device)
        self.counters = counters if counters is not None else EncodeCounters()

    def _positioned_band_pipeline(self, *args) -> tuple[Iterator[np.ndarray], PngHeader]:
        """The parent's, with every band a host array, as ``stream_bands``
        hands them out: a band blended on the device is read back."""
        bands, out_header = super()._positioned_band_pipeline(*args)
        return (_to_host(band) for band in bands), out_header

    def _stream_positioned(self, inputs, decoders, image_headers, headers,
                           target_depth) -> Iterator[bytes]:
        """The parent's (image_stitch_tpu/core.py:812-829), with the bands
        as the compositor leaves them: PNG output filters a band blended on
        the device where it lies, and ``_encode_jpeg`` reads it back."""
        bands, out_header = super()._positioned_band_pipeline(
            inputs, decoders, image_headers, headers, target_depth
        )
        if self.options.output_format == "jpeg":
            yield from self._encode_jpeg(bands, out_header)
        else:
            yield PNG_SIGNATURE
            yield serialize_chunk(create_ihdr(out_header))
            yield from self._encode_png(bands, out_header)
            yield serialize_chunk(create_iend())

    def _positioned_canvas_bands(
        self,
        placed,
        clip_by_idx,
        sources: Sequence[RowSource],
        out_header: PngHeader,
    ) -> Iterator[np.ndarray | torch.Tensor]:
        """Assemble positioned-mode bands back to front.

        A copy of ``CoreStreamingConcatenator._positioned_canvas_bands``
        (image_stitch_tpu/core.py:831-942) that changes two things: the
        compositor (:847-860) is a torch ``DeviceCompositor`` whenever
        blending is on and the band is 8-bit; and the hand-off (:920-934)
        yields the blended band as the device tensor it is."""
        opts = self.options
        bg = background_pixel(out_header.bit_depth, opts.background_color)
        dtype = np.uint16 if out_header.bit_depth == 16 else np.uint8
        band_h = opts.band_height
        blend = opts.enable_alpha_blending is not False

        compositor = None
        if blend and dtype == np.uint8:
            compositor = DeviceCompositor(self.device, self.counters)

        plans = build_band_plan(placed, out_header.height, band_h)
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
                # Pulls parallelize across images; a given source's pulls
                # stay ordered (skip/take move its row cursor), so each
                # worker owns every segment of one image, in band order, and
                # seg_rows is reassembled in z-sorted segment order.
                by_image: dict[int, list[int]] = {}
                for i, seg in enumerate(segs):
                    by_image.setdefault(seg.image_idx, []).append(i)

                def pull_image(indices: list[int]):
                    return [(i, pull_seg(segs[i])) for i in indices]

                futs = [pool.submit(pull_image, indices) for indices in by_image.values()]
                gathered: dict[int, tuple[np.ndarray, int, int]] = {}
                for fut in futs:
                    for i, res in fut.result():
                        gathered[i] = res
                seg_rows = [gathered[i] for i in range(len(segs))]
            else:
                for seg in segs:
                    seg_rows.append(pull_seg(seg))
            if compositor is not None and seg_rows:
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

    def _encode_png(self, bands: Iterator[np.ndarray | torch.Tensor],
                    out_header: PngHeader) -> Iterator[bytes]:
        """Filter-select each band on the device, feed the streaming
        deflator, emit IDAT chunks as they form: the parent's body
        (image_stitch_tpu/core.py:946-1013) with ``TorchBackend`` in place
        of ``get_backend``, which would pick the host tier from the
        inherited ``backend="numpy"``."""
        backend = TorchBackend(self.device, self.counters)
        chunks: list[bytes] = []
        deflator = StreamingDeflator(
            level=self.options.png_compression_level,
            on_data=chunks.append,
            strategy=self.options.png_compression_strategy,
            pool=self._host_pool(),
            content_hint="filtered_png",
        )

        def emit(pending) -> Iterator[bytes]:
            ftypes, filtered, _last = backend.png_filter_band_wait(pending)
            h = filtered.shape[0]
            interleaved = np.empty((h, 1 + filtered.shape[1]), dtype=np.uint8)
            interleaved[:, 0] = ftypes
            interleaved[:, 1:] = filtered
            deflator.push(interleaved.tobytes())
            while chunks:
                yield serialize_chunk(create_idat(chunks.pop(0)))

        # One-band lookahead: submit band N (device filter select and the
        # queued read-back), then deflate band N-1 on the host. The carry
        # row is input data that stays on the device, so a submit never
        # waits on device results.
        prev_row = None
        pending = None
        for canvas in bands:
            self.stats.record_band(canvas.shape[0], canvas.shape[1])
            handle = backend.png_filter_band_async(canvas, prev_row)
            prev_row = handle.carry
            if pending is not None:
                yield from emit(pending)
            pending = handle
        if pending is not None:
            yield from emit(pending)
        deflator.finish()
        while chunks:
            yield serialize_chunk(create_idat(chunks.pop(0)))

    def _encode_jpeg(self, bands: Iterator[np.ndarray | torch.Tensor],
                     out_header: PngHeader) -> Iterator[bytes]:
        """The parent's JPEG stage on ``TorchStreamingJpegEncoder``, which
        takes host bands: a band blended on the device is read back."""
        encoder = TorchStreamingJpegEncoder(
            width=out_header.width,
            height=out_header.height,
            quality=self.options.jpeg_quality,
            sampling=self.options.jpeg_sampling,
            restart_interval_rows=self.options.jpeg_restart_interval_rows,
            device=self.device,
            counters=self.counters,
        )
        yield from encoder.header()
        for canvas in bands:
            canvas = _to_host(canvas)
            if canvas.dtype != np.uint8 or canvas.ndim != 3:
                raise StitchError("JPEG encoding requires 8-bit canvas bands")
            self.stats.record_band(canvas.shape[0], canvas.shape[1])
            yield from encoder.encode_band(canvas)
        yield from encoder.finish()
