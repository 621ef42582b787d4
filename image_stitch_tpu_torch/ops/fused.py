"""Fused uniform-grid compose + encode on one torch device.

The counterpart of ``image_stitch_tpu/ops/fused.py``. A uniform grid of
same-sized tiles becomes its canvas band by a transpose and reshape (one
copy on the device), and the canvas then goes to both encoders' first
stages: the PNG filter select (``kernels.filter_select``, csrc/filter.cu)
and the JPEG colour, FDCT and quantize (``kernels.fdct_quant``,
csrc/fdct_quant.cu), the plain torch versions for CPU tensors.

The sharded forms are in :mod:`image_stitch_tpu_torch.parallel.mesh`.
"""

from __future__ import annotations

import torch

from .device import jpeg_quantize
from .kernels import filter_select


def assemble_uniform_grid(tiles: torch.Tensor) -> torch.Tensor:
    """(gy, gx, th, tw, 4) tiles -> (gy*th, gx*tw, 4) canvas."""
    gy, gx, th, tw, c = tiles.shape
    return tiles.permute(0, 2, 1, 3, 4).reshape(gy * th, gx * tw, c)


def fused_grid_png_step(tiles: torch.Tensor, prev_row: torch.Tensor):
    """Uniform grid band -> PNG filter-selected rows.

    tiles: (gy, gx, th, tw, 4) uint8. prev_row: (gx*tw*4,) uint8 carry.
    Returns (filter_types (gy*th,) int32, filtered (gy*th, W*4) uint8,
    last_raw (W*4,) uint8), as the JAX package's step."""
    canvas = assemble_uniform_grid(tiles)
    h, w, _ = canvas.shape
    raw = canvas.reshape(h, w * 4)
    types, filtered = filter_select(raw, prev_row, 4)
    return types.to(torch.int32), filtered, raw[-1]


def fused_grid_jpeg_step(tiles: torch.Tensor, luma_q: torch.Tensor, chroma_q: torch.Tensor):
    """Uniform grid band -> quantized JPEG blocks (Y, Cb, Cr), int16,
    strip-major."""
    return jpeg_quantize(assemble_uniform_grid(tiles), luma_q, chroma_q)


def fused_grid_dual_step(tiles: torch.Tensor, prev_row: torch.Tensor, luma_q: torch.Tensor,
                         chroma_q: torch.Tensor):
    """Both encoders from one canvas: (filter types, filtered, last raw row,
    y, cb, cr)."""
    canvas = assemble_uniform_grid(tiles)
    h, w, _ = canvas.shape
    raw = canvas.reshape(h, w * 4)
    types, filtered = filter_select(raw, prev_row, 4)
    yb, cbb, crb = jpeg_quantize(canvas, luma_q, chroma_q)
    return types.to(torch.int32), filtered, raw[-1], yb, cbb, crb
