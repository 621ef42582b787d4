"""Fused uniform-grid compose + encode on one torch device.

The counterpart of ``image_stitch_tpu/ops/fused.py``. A uniform grid of
same-sized tiles, stacked (gy, gx, th, tw, 4), goes to both encoders' first
stages, the PNG filter select and the JPEG colour, FDCT and quantize, in one
launch of ``kernels.grid_dual`` (csrc/grid_dual.cu), which reads the tile
stack where it lies: the canvas is never assembled on the card.

The ``*_plain`` steps are the composition that kernel replaces: the canvas
assembled by a transpose and reshape (a copy), then ``kernels.filter_select``
(csrc/filter.cu) and ``kernels.fdct_quant`` (csrc/fdct_quant.cu), the plain
torch versions on CPU tensors.

The sharded forms are in :mod:`image_stitch_tpu_torch.parallel.mesh`.
"""

from __future__ import annotations

import torch

from .kernels import grid_dual, grid_dual_composed, grid_rows


def assemble_uniform_grid(tiles: torch.Tensor) -> torch.Tensor:
    """(gy, gx, th, tw, 4) tiles -> (gy*th, gx*tw, 4) canvas."""
    return grid_rows(tiles, 0, tiles.shape[0] * tiles.shape[2])


def fused_grid_png_step(tiles: torch.Tensor, prev_row: torch.Tensor):
    """Uniform grid band -> PNG filter-selected rows.

    tiles: (gy, gx, th, tw, 4) uint8. prev_row: (gx*tw*4,) uint8 carry.
    Returns (filter_types (gy*th,) int32, filtered (gy*th, W*4) uint8,
    last_raw (W*4,) uint8), as the JAX package's step."""
    return grid_dual(tiles, prev_row, None, None, png=True, jpeg=False)


def fused_grid_jpeg_step(tiles: torch.Tensor, luma_q: torch.Tensor, chroma_q: torch.Tensor):
    """Uniform grid band -> quantized JPEG blocks (Y, Cb, Cr), int16,
    strip-major."""
    return grid_dual(tiles, None, luma_q, chroma_q, png=False, jpeg=True)


def fused_grid_dual_step(tiles: torch.Tensor, prev_row: torch.Tensor, luma_q: torch.Tensor,
                         chroma_q: torch.Tensor):
    """Both encoders from one read of the tile stack: (filter types, filtered,
    last raw row, y, cb, cr)."""
    return grid_dual(tiles, prev_row, luma_q, chroma_q)


def _rows(tiles: torch.Tensor) -> int:
    return tiles.shape[0] * tiles.shape[2]


def fused_grid_png_step_plain(tiles: torch.Tensor, prev_row: torch.Tensor):
    """``fused_grid_png_step`` as the composition: the canvas assembled, then
    filter select."""
    return grid_dual_composed(tiles, prev_row, None, None, 0, _rows(tiles), jpeg=False)


def fused_grid_jpeg_step_plain(tiles: torch.Tensor, luma_q: torch.Tensor,
                               chroma_q: torch.Tensor):
    """``fused_grid_jpeg_step`` as the composition: the canvas assembled, then
    the quantize."""
    return grid_dual_composed(tiles, None, luma_q, chroma_q, 0, _rows(tiles), png=False)


def fused_grid_dual_step_plain(tiles: torch.Tensor, prev_row: torch.Tensor,
                               luma_q: torch.Tensor, chroma_q: torch.Tensor):
    """``fused_grid_dual_step`` as the composition: the canvas assembled,
    then filter select and the quantize, each reading it."""
    return grid_dual_composed(tiles, prev_row, luma_q, chroma_q, 0, _rows(tiles))
