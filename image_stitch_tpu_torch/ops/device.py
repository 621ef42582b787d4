"""Band entry points on a torch device: JPEG quantize and PNG filter select.

``jpeg_quantize`` and ``jpeg_quantize_420`` are the counterparts of
``image_stitch_tpu/ops/device.py::jpeg_quantize_trace`` and
``jpeg_quantize_420_trace``: on a CUDA band they launch the kernel
``kernels.fdct_quant`` (csrc/fdct_quant.cu), on a CPU band its plain
version (``ops/jpeg_dct.py``). ``TorchBackend`` is the counterpart of that
module's ``JaxBackend``: its filter select is the CUDA kernel
``kernels.filter_select`` and its JPEG quantize ``kernels.fdct_quant``,
each launched once per band, or with a ``mesh`` once per non-empty row
slab, on the slab's shard.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..parallel.mesh import Mesh, band_rows, row_slabs
from ..utils.observability import span
from .counters import EncodeCounters
from .kernels import fdct_quant, filter_select, png_bytes
from .resolve import resolve_device
from .staging import upload


def jpeg_quantize(band: torch.Tensor, luma_q: torch.Tensor, chroma_q: torch.Tensor):
    """YCbCr + FDCT + quantize of a (H, W, >=3) uint8 band, H and W
    multiples of 8. Returns (y, cb, cr), each (H/8 * W/8, 64) int16
    natural-order blocks, strip-major."""
    return fdct_quant(band, luma_q, chroma_q, "444")


def jpeg_quantize_420(band: torch.Tensor, luma_q: torch.Tensor, chroma_q: torch.Tensor):
    """4:2:0 quantize of a (16k, W, >=3) uint8 band with W % 16 == 0.
    Returns (y (4n, 64) in MCU order [TL, TR, BL, BR], cb (n, 64),
    cr (n, 64)) int16, n MCUs raster-major."""
    return fdct_quant(band, luma_q, chroma_q, "420")


@dataclass
class PendingFilter:
    """A submitted band's filter select. ``types``, ``filtered`` and
    ``last`` are host tensors (pinned on CUDA) that the events in ``done``
    mark filled (one, or under a mesh one per slab; none on the CPU);
    ``carry`` is the last raw row on the device, the next band's ``prev``."""

    types: torch.Tensor
    filtered: torch.Tensor
    last: torch.Tensor
    carry: torch.Tensor
    done: list[torch.cuda.Event]


@dataclass
class PendingQuantize:
    """A submitted band's quantized blocks: (y, cb, cr) host tensors (pinned
    on CUDA) that the events in ``done`` mark filled (one, or under a mesh
    one per slab; none on the CPU)."""

    blocks: tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    done: list[torch.cuda.Event]


class TorchBackend:
    """PNG filter select and JPEG quantize of ``image_stitch_tpu.ops.
    backend``'s backend contract on a torch device.

    ``png_filter_band_async`` never waits for the device: it uploads a host
    band through pinned memory (a tensor is taken where it lies), launches
    the filter kernel and queues the read-back into pinned host buffers on
    the current stream. The carry row stays on the device from band to
    band. ``png_filter_band_wait`` is the only place that synchronises.

    With ``mesh``, the counterpart of ``JaxBackend(mesh=)``: the band's rows
    split by ``row_slabs(h, mesh.size, 1)``, each non-empty slab filtered on
    its shard after the raw row just above it (the one-row halo; from a host
    band it is uploaded with the slab) and read back into its rows of the
    band's pinned buffers on the shard's stream. The carry is the last
    slab's last raw row. The JPEG quantize splits rows in whole 8-row strips
    (``row_slabs(h, mesh.size, 8)``), each slab's blocks read back into
    their rows of the band's blocks."""

    name = "torch"

    def __init__(self, device, counters: EncodeCounters | None = None,
                 mesh: Mesh | None = None):
        self.device = resolve_device(device)
        self.counters = counters if counters is not None else EncodeCounters()
        self.mesh = mesh

    def _on_device(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            if a.device.type != self.device.type:
                raise ValueError(f"tensor on {a.device}, the backend runs on {self.device}")
            return a.contiguous()
        with span("png.upload") as s:
            s.n = a.nbytes
            return upload(a, self.device)

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t, non_blocking=True)

    def png_filter_band_async(self, canvas, prev_row) -> PendingFilter:
        """Queue the filter select of ``canvas`` ((H, W, 4) uint8 or uint16,
        host array or tensor) after ``prev_row`` (the previous band's last
        raw row, host or device, or None at the image start)."""
        with span("png.submit"):
            if self.mesh is not None:
                return self._filter_sharded(canvas, prev_row)
            return self._filter(canvas, prev_row)

    def _filter(self, canvas, prev_row) -> PendingFilter:
        band = self._on_device(canvas)
        if band.ndim != 3 or band.dtype not in (torch.uint8, torch.uint16):
            raise TypeError(f"expected an (H, W, 4) uint8 or uint16 band, got "
                            f"{tuple(band.shape)} {band.dtype}")
        bpp = 8 if band.dtype == torch.uint16 else 4
        n = band.shape[1] * band.shape[2] * band.element_size()
        if prev_row is None:
            prev = torch.zeros(n, dtype=torch.uint8, device=band.device)
        else:
            prev = self._on_device(prev_row)
        types, filtered = filter_select(band, prev, bpp)
        carry = png_bytes(band[-1:])[0]
        self.counters.png_bands += 1
        if band.device.type != "cuda":
            return PendingFilter(types, filtered, carry, carry, [])
        done = torch.cuda.Event()
        pending = PendingFilter(self._to_host(types), self._to_host(filtered),
                                self._to_host(carry), carry, [done])
        done.record()
        return pending

    def _filter_sharded(self, canvas, prev_row) -> PendingFilter:
        """The band's filter select over the mesh, slab by slab."""
        if canvas.ndim != 3 or canvas.dtype not in (np.uint8, np.uint16, torch.uint8,
                                                    torch.uint16):
            raise TypeError(f"expected an (H, W, 4) uint8 or uint16 band, got "
                            f"{tuple(canvas.shape)} {canvas.dtype}")
        h, w, c = canvas.shape
        wide = canvas.dtype in (np.uint16, torch.uint16)
        bpp, n = (8, w * c * 2) if wide else (4, w * c)
        on_card = self.mesh.device_type == "cuda"
        types = torch.empty(h, dtype=torch.uint8, pin_memory=on_card)
        filtered = torch.empty((h, n), dtype=torch.uint8, pin_memory=on_card)
        last = torch.empty(n, dtype=torch.uint8, pin_memory=on_card)
        host_band = isinstance(canvas, np.ndarray)
        done, carry = [], None
        for i, (r0, r1) in enumerate(row_slabs(h, self.mesh.size, 1)):
            if r1 == r0:
                continue
            with self.mesh.shard(i) as dev:
                if host_band and r0:
                    rows = band_rows(canvas, r0 - 1, r1, dev)  # the halo row with the slab
                    prev, slab = png_bytes(rows[:1])[0], rows[1:]
                else:
                    slab = band_rows(canvas, r0, r1, dev).contiguous()
                    if r0:
                        prev = png_bytes(band_rows(canvas, r0 - 1, r0, dev))[0]
                    elif prev_row is None:
                        prev = torch.zeros(n, dtype=torch.uint8, device=dev)
                    else:
                        prev = band_rows(prev_row[None], 0, 1, dev)[0]
                t, f = filter_select(slab, prev.contiguous(), bpp)
                types[r0:r1].copy_(t, non_blocking=True)
                filtered[r0:r1].copy_(f, non_blocking=True)
                if r1 == h:
                    carry = png_bytes(slab[-1:])[0]
                    last.copy_(carry, non_blocking=True)
                if on_card:
                    done.append(torch.cuda.Event())
                    done[-1].record()
            self.counters.mesh_slabs += 1
        self.counters.png_bands += 1
        return PendingFilter(types, filtered, last, carry, done)

    @staticmethod
    def png_filter_band_wait(pending: PendingFilter) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(types (H,) uint8, filtered (H, N) uint8, last raw row (N,))."""
        with span("png.device_wait"):
            for done in pending.done:
                done.synchronize()
        return pending.types.numpy(), pending.filtered.numpy(), pending.last.numpy()

    def png_filter_band(self, canvas, prev_row) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self.png_filter_band_wait(self.png_filter_band_async(canvas, prev_row))

    def _tables(self, luma_q, chroma_q, dev: torch.device) -> list[torch.Tensor]:
        return [(q if isinstance(q, torch.Tensor) else torch.from_numpy(np.asarray(q)))
                .to(device=dev, dtype=torch.int32).contiguous() for q in (luma_q, chroma_q)]

    def jpeg_quantize_band_async(self, band, luma_q, chroma_q) -> PendingQuantize:
        """Queue the 4:4:4 quantize of ``band`` ((8k, W8, >= 3) uint8, host
        array or tensor) with the (64,) natural-order tables (host or
        device): ``kernels.fdct_quant`` once, or once per non-empty slab of
        whole 8-row strips over the mesh, the blocks read back into pinned
        host tensors."""
        if self.mesh is not None:
            return self._quantize_sharded(band, luma_q, chroma_q)
        b = self._on_device(band)
        blocks = jpeg_quantize(b, *self._tables(luma_q, chroma_q, b.device))
        if b.device.type != "cuda":
            return PendingQuantize(blocks, [])
        done = torch.cuda.Event()
        pending = PendingQuantize(tuple(self._to_host(t) for t in blocks), [done])
        done.record()
        return pending

    def _quantize_sharded(self, band, luma_q, chroma_q) -> PendingQuantize:
        """The band's quantize over the mesh, slab by slab."""
        h, w = band.shape[:2]
        if h % 8 or w % 8:
            raise ValueError(f"band {h} x {w}: rows and columns must be multiples of 8")
        on_card = self.mesh.device_type == "cuda"
        n = (h // 8) * (w // 8)
        blocks = tuple(torch.empty((n, 64), dtype=torch.int16, pin_memory=on_card)
                       for _ in range(3))
        done = []
        for i, (r0, r1) in enumerate(row_slabs(h, self.mesh.size, 8)):
            if r1 == r0:
                continue
            with self.mesh.shard(i) as dev:
                slab = band_rows(band, r0, r1, dev).contiguous()
                part = jpeg_quantize(slab, *self._tables(luma_q, chroma_q, dev))
                at = slice(r0 // 8 * (w // 8), r1 // 8 * (w // 8))
                for out, t in zip(blocks, part):
                    out[at].copy_(t, non_blocking=True)
                if on_card:
                    done.append(torch.cuda.Event())
                    done[-1].record()
            self.counters.mesh_slabs += 1
        return PendingQuantize(blocks, done)

    @staticmethod
    def jpeg_quantize_band_wait(pending: PendingQuantize) -> tuple[np.ndarray, ...]:
        """(y, cb, cr), each (k * W8 / 8, 64) int16."""
        for done in pending.done:
            done.synchronize()
        return tuple(t.numpy() for t in pending.blocks)

    def jpeg_quantize_band(self, band, luma_q, chroma_q) -> tuple[np.ndarray, ...]:
        """(8k, W8, >= 3) uint8 -> three (k * W8 / 8, 64) int16 block arrays."""
        return self.jpeg_quantize_band_wait(self.jpeg_quantize_band_async(band, luma_q, chroma_q))

    def jpeg_quantize_strip(self, strip, luma_q, chroma_q) -> tuple[np.ndarray, ...]:
        return self.jpeg_quantize_band(strip, luma_q, chroma_q)
