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

With a ``mesh`` (the counterpart of ``_composite_jit(mesh)`` and
``_bg_canvas_jit(mesh)``) the band's rows split by ``row_slabs`` at the
consumer's alignment, so that the encoder takes each slab where it was
made: the segments' pixels go up once per distinct device, and each shard
launches ``composite_segments`` on its slab with the segments clipped to it
(first row, height and byte offset). The ties are summed over the shards.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.mesh import Mesh, ShardedBand, row_slabs
from .counters import EncodeCounters
from .resolve import resolve_device
from .staging import upload
from .kernels import META_COLS, META_H, META_OFFSET, META_STRIDE, META_Y0, composite_segments


def _pack(parts: list[np.ndarray]) -> np.ndarray:
    """The segments' pixels back to back in one uint8 buffer."""
    return np.concatenate([p.reshape(-1) for p in parts])


def _clip_metas(metas: np.ndarray, r0: int, r1: int) -> np.ndarray:
    """The meta rows of the segments that meet band rows [r0, r1), clipped
    to them, in the slab's own rows."""
    top = np.maximum(metas[:, META_Y0], r0)
    bottom = np.minimum(metas[:, META_Y0] + metas[:, META_H], r1)
    keep = bottom > top
    out = metas[keep].copy()
    out[:, META_OFFSET] += (top[keep] - out[:, META_Y0]) * out[:, META_STRIDE]
    out[:, META_Y0] = top[keep] - r0
    out[:, META_H] = bottom[keep] - top[keep]
    return out


class DeviceCompositor:
    """Per-band compositing on ``device`` with host-oracle replay on ties.

    ``bands_on_device`` and ``bands_fallback`` read ``counters``
    (``composite_bands_on_device``, ``composite_fallback_bands``)."""

    def __init__(self, device, counters: EncodeCounters | None = None,
                 mesh: Mesh | None = None, align: int = 1):
        self.device = resolve_device(device)
        self.counters = counters if counters is not None else EncodeCounters()
        self.mesh = mesh
        self.align = align

    @property
    def bands_on_device(self) -> int:
        return self.counters.composite_bands_on_device

    @property
    def bands_fallback(self) -> int:
        return self.counters.composite_fallback_bands

    def composite_band(self, canvas: np.ndarray,
                       segments: list[tuple[np.ndarray, int, int]]) -> torch.Tensor | None:
        """Blend ``segments`` = [(rows (h, w, 4) uint8, band_y0, start_x)]
        (z-sorted, back to front) into ``canvas`` (H, W, 4) uint8, which
        must be a uniform background fill: only four of its pixels and its
        shape are read.

        Returns the blended band as a tensor on the device (a
        ``ShardedBand`` under a mesh), or None when the band must take the
        host oracle: 16-bit, no segments, a canvas that is not uniform, or an
        exact rational tie. Reading the tie count is this method's one
        synchronisation."""
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
        srcs = _pack(parts)
        if self.mesh is None:
            band, ties = composite_segments(upload(metas, self.device), upload(srcs, self.device),
                                            bg.tolist(), h_canvas, w_canvas)
        else:
            band, ties = self._composite_sharded(metas, srcs, bg.tolist(), h_canvas, w_canvas)
        if int(ties):
            # Exact rational tie: float64 rounding may differ; the caller
            # replays the band through the host oracle.
            self.counters.composite_fallback_bands += 1
            return None
        self.counters.composite_bands_on_device += 1
        return band

    def _composite_sharded(self, metas: np.ndarray, srcs: np.ndarray, bg: list[int],
                           h_canvas: int, w_canvas: int):
        """One ``composite_segments`` launch per non-empty slab, on its
        shard; returns (ShardedBand, summed ties)."""
        on_device = {d: None for d in self.mesh.distinct()}
        slabs, ties = [], []
        for i, (r0, r1) in enumerate(row_slabs(h_canvas, self.mesh.size, self.align)):
            if r1 == r0:
                continue
            with self.mesh.shard(i) as dev:
                if on_device[dev] is None:
                    on_device[dev] = upload(srcs, dev)
                band, t = composite_segments(upload(_clip_metas(metas, r0, r1), dev),
                                             on_device[dev], bg, r1 - r0, w_canvas)
            slabs.append((r0, band))
            ties.append(t)
        return ShardedBand(slabs), sum(int(t) for t in ties)
