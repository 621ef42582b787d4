"""Pinned host staging for uploads.

``BandStaging`` is a ring of buffers a band is copied into before its
queued host-to-device copy. Two users: the JPEG-tile device decode
(``codecs/jpeg/device_decoder.stage_tiles_band``) stages a band's
coefficients and tables in one buffer, and ``TorchJpegEncoder`` stages each
host band as it lies (RGBA, or any (H, W, C >= 3)) in one copy.

``upload`` pins a host array and queues its copy, with no ring: the PNG
filter's bands (``ops/device.py``), the compositor's segments
(``ops/composite_device.py``) and a mesh's host slabs
(``parallel/mesh.band_rows``).
"""

from __future__ import annotations

import numpy as np
import torch

from .resolve import resolve_device

# Buffers of a staging ring: the host fills one while the copy of the band
# before may still read the other. The events guard a buffer's reuse only
# because there are two.
STAGING_RING = 2


class BandStaging:
    """The pinned host buffers a band's upload is staged in: a ring of
    ``STAGING_RING`` buffers. Each is guarded by an event recorded right
    after its copy was enqueued: ``acquire`` waits for that event before it
    hands the buffer out again, so the host never writes memory that a copy
    in flight reads. On the CPU the buffers are plain tensors and there is
    nothing to wait for."""

    def __init__(self, device):
        self.device = resolve_device(device)
        self._buffers: list[torch.Tensor | None] = [None] * STAGING_RING
        self._events: list[object | None] = [None] * STAGING_RING
        self._next = 0
        self.waits = 0  # acquires that found their buffer's copy guarded by an event
        self.stalls = 0  # of those, the ones whose copy was still in flight
        self.uploads = 0  # slots handed to ``upload``

    def acquire(self, nbytes: int) -> tuple[int, torch.Tensor]:
        """The next buffer of the ring, at least ``nbytes`` long, free to
        write: (its slot, the uint8 tensor)."""
        slot = self._next
        self._next = (slot + 1) % STAGING_RING
        event = self._events[slot]
        if event is not None:
            if not event.query():
                self.stalls += 1
            event.synchronize()
            self._events[slot] = None
            self.waits += 1
        buf = self._buffers[slot]
        if buf is None or buf.numel() < nbytes:
            # Grown in steps of a quarter, so that bands of slightly
            # different sizes do not each pin a new buffer.
            buf = torch.empty(max(nbytes, 1) * 5 // 4, dtype=torch.uint8,
                              pin_memory=self.device.type == "cuda")
            self._buffers[slot] = buf
        return slot, buf

    def upload(self, slot: int, nbytes: int) -> torch.Tensor:
        """The first ``nbytes`` of the slot's buffer on the device: one
        asynchronous copy, with the slot's event recorded behind it. On the
        CPU the buffer itself."""
        host = self._buffers[slot][:nbytes]
        self.uploads += 1
        if self.device.type != "cuda":
            return host
        dev = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
        dev.copy_(host, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self._events[slot] = event
        return dev


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array ``a`` on ``device``: on a card, pinned and its copy queued
    on the current stream; on the CPU, a tensor over ``a``'s memory (made
    contiguous). 16-bit samples travel as their bytes, since torch has few
    uint16 ops, and come back as a uint16 view."""
    a = np.ascontiguousarray(a)
    wide = a.dtype == np.uint16
    host = torch.from_numpy(a.view(np.uint8) if wide else a)
    if device.type == "cuda":
        host = host.pin_memory().to(device, non_blocking=True)
    return host.view(torch.uint16) if wide else host
