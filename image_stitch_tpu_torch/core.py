"""Band-streaming concatenator whose JPEG encode runs in torch.

``TorchStreamingConcatenator`` is the JAX package's
``CoreStreamingConcatenator`` with ``_encode_jpeg`` overridden: decoding,
layout, band assembly and positioned compositing stay the parent's host
code (the ``numpy`` route, as with the JAX package's numpy backend), and
each assembled band goes to a ``TorchStreamingJpegEncoder`` on ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Mapping

import numpy as np
import torch

from image_stitch_tpu.core import CoreStreamingConcatenator
from image_stitch_tpu.errors import StitchError
from image_stitch_tpu.types import ConcatOptions, PngHeader

from .codecs.jpeg.encoder import TorchStreamingJpegEncoder
from .ops.jpeg_entropy_device import EncodeCounters


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


class TorchStreamingConcatenator(CoreStreamingConcatenator):
    """Concatenate to JPEG with the band encode on a torch device.

    Only JPEG output is ported: PNG output raises (ROADMAP.md, "Still to
    port", item 2). ``mesh`` and any ``backend`` other than "auto" or
    "torch" raise, since they name another package's path."""

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
        if opts.output_format != "jpeg":
            raise StitchError(
                f"outputFormat={opts.output_format!r} is not ported to "
                "image_stitch_tpu_torch yet (ROADMAP.md, 'Still to port' item 2: "
                "_filter_kernel with PNG output); only 'jpeg' is"
            )
        # The inherited host layers take their numpy route; a copy keeps the
        # caller's options unchanged.
        super().__init__(dataclasses.replace(opts, backend="numpy"))
        self.device = resolve_device(device)
        self.counters = counters if counters is not None else EncodeCounters()

    def _encode_jpeg(self, bands: Iterator[np.ndarray], out_header: PngHeader) -> Iterator[bytes]:
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
            if canvas.dtype != np.uint8 or canvas.ndim != 3:
                raise StitchError("JPEG encoding requires 8-bit canvas bands")
            self.stats.record_band(canvas.shape[0], canvas.shape[1])
            yield from encoder.encode_band(canvas)
        yield from encoder.finish()
