"""Positioned alpha compositing of a band on a torch device.

The counterpart of ``image_stitch_tpu/ops/composite_device.py``'s
``DeviceCompositor``: the band's z-ordered segments blend over its uniform
background in one launch of ``kernels.composite_segments``, in exact
integer rationals, and a band with an exact rational tie is replayed
through the host's float64 oracle (``ops.pixel.composite_band``, the
port's copy), where the two may round apart. The JAX module's docstring
gives the exactness argument, and why 16-bit bands stay on the host.

The TPU compile-cache workarounds are not ported: the kernel takes any
band and segment size, so the segments' real pixels go up unpadded in one
upload, with no size buckets, runs or program registry.
"""

from __future__ import annotations

import numpy as np
import torch

from .counters import EncodeCounters
from .kernels import META_COLS, composite_segments


def _pack(parts: list[np.ndarray]) -> np.ndarray:
    """The segments' pixels back to back in one uint8 buffer."""
    return np.concatenate([p.reshape(-1) for p in parts])


class DeviceCompositor:
    """Per-band compositing on ``device`` with host-oracle replay on ties.

    ``bands_on_device`` and ``bands_fallback`` read ``counters``
    (``composite_bands_on_device``, ``composite_fallback_bands``)."""

    def __init__(self, device, counters: EncodeCounters | None = None):
        self.device = torch.device(device)
        self.counters = counters if counters is not None else EncodeCounters()

    @property
    def bands_on_device(self) -> int:
        return self.counters.composite_bands_on_device

    @property
    def bands_fallback(self) -> int:
        return self.counters.composite_fallback_bands

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(a)
        if self.device.type == "cuda":
            return host.pin_memory().to(self.device, non_blocking=True)
        return host

    def composite_band(self, canvas: np.ndarray,
                       segments: list[tuple[np.ndarray, int, int]]) -> torch.Tensor | None:
        """Blend ``segments`` = [(rows (h, w, 4) uint8, band_y0, start_x)]
        (z-sorted, back to front) into ``canvas`` (H, W, 4) uint8, which
        must be a uniform background fill: only four of its pixels and its
        shape are read.

        Returns the blended band as a tensor on the device, or None when the
        band must take the host oracle: 16-bit, no segments, a canvas that
        is not uniform, or an exact rational tie. Reading the tie count is
        this method's one synchronisation."""
        if canvas.dtype != np.uint8 or not segments:
            return None
        h_canvas, w_canvas = canvas.shape[:2]
        bg = canvas[0, 0]
        # Spot-check the uniform-fill contract, so that a caller with drawn
        # content takes the exact host path instead of losing its pixels.
        if not (
            np.array_equal(canvas[-1, -1], bg)
            and np.array_equal(canvas[0, -1], bg)
            and np.array_equal(canvas[h_canvas // 2, w_canvas // 2], bg)
        ):
            return None
        metas = np.zeros((len(segments), META_COLS), dtype=np.int64)
        parts = []
        offset = 0
        for i, (rows, y0, x0) in enumerate(segments):
            # Parts outside the band are never seen: clip them here.
            rows = rows[: max(0, h_canvas - y0), : max(0, w_canvas - x0)]
            h, w = rows.shape[:2]
            metas[i] = (y0, x0, h, w, offset, w * 4)
            parts.append(rows)
            offset += rows.size
        band, ties = composite_segments(
            self._upload(metas), self._upload(_pack(parts)), bg.tolist(), h_canvas, w_canvas
        )
        if int(ties):
            # Exact rational tie: float64 rounding may differ; the caller
            # replays the band through the host oracle.
            self.counters.composite_fallback_bands += 1
            return None
        self.counters.composite_bands_on_device += 1
        return band
