"""Compute backends for the band pipeline.

A copy of ``image_stitch_tpu/ops/backend.py``'s host tier and name
resolution. The orchestrator is backend-agnostic: ``numpy`` (the host
oracle: the C++ host library where it builds, numpy otherwise; the bytes of
the JAX package's ``backend="numpy"``) and ``torch`` (``ops.device.
TorchBackend``: the hand-written kernels on a torch device). Both are
bit-exact for everything the reference's grid mode does (pure integer math).

Not copied: ``LinkProfile``, ``decide_auto_backend``, the link probe and its
cache, and the cost model's constants, which were measured on a TPU and its
link. They wait for the auto policy (ROADMAP §1 item 4 step 2), whose
constants come from H100 rows. Until then "auto" means "torch": the port's
entry points run on the card unless the caller asks for the host.
"""

from __future__ import annotations

import numpy as np

from ..errors import StitchError
from .counters import EncodeCounters
from .device import TorchBackend
from .pixel import band_to_bytes
from .png_filter import filter_select_band


class NumpyBackend:
    """Host-side oracle backend. The async API is the sync one (compute on
    submit, identity on wait) so the orchestrator has one pipeline shape."""

    name = "numpy"

    def png_filter_band(
        self, canvas: np.ndarray, prev_row: np.ndarray | None
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Filter-select a canvas band.

        ``canvas``: (H, W, 4) uint8/uint16. ``prev_row``: previous *raw* row
        bytes (W*bpp,) or None. Returns (filter_types (H,), filtered rows
        (H, W*bpp), last raw row (W*bpp,)) — the carry for the next band.
        """
        bpp = 8 if canvas.dtype == np.uint16 else 4
        raw = band_to_bytes(canvas)
        from ..native import filter_select_band_native

        native = filter_select_band_native(raw, prev_row, bpp)
        if native is not None:
            types, filtered = native
        else:
            types, filtered = filter_select_band(raw, prev_row, bpp)
        return types, filtered, raw[-1]

    def png_filter_band_async(self, canvas, prev_row):
        return self.png_filter_band(canvas, prev_row)

    @staticmethod
    def png_filter_band_wait(pending):
        return pending


_NUMPY_BACKEND = NumpyBackend()


def resolve_backend_name(name: str, canvas_pixels: int | None = None) -> str:
    """Map option strings to a concrete backend: "oracle" and "numpy" ->
    "numpy", "auto" and "torch" -> "torch"; any other name ("jax", "tpu",
    ...) raises. ``canvas_pixels`` keeps the JAX package's signature; no
    policy reads it yet."""
    key = {"oracle": "numpy", "auto": "torch"}.get(name, name)
    if key not in ("numpy", "torch"):
        raise StitchError(
            f"backend={name!r} is not a path of image_stitch_tpu_torch; "
            "use 'torch' (or leave it unset)"
        )
    return key


def get_backend(name: str, device=None, counters: EncodeCounters | None = None):
    """'oracle'/'numpy' -> the shared NumpyBackend; 'auto'/'torch' ->
    TorchBackend(device, counters)."""
    if resolve_backend_name(name) == "numpy":
        return _NUMPY_BACKEND
    return TorchBackend(device, counters)
