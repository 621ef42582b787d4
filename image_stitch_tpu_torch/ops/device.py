"""Band quantize entry points, the counterparts of
``image_stitch_tpu/ops/device.py::jpeg_quantize_trace`` and
``jpeg_quantize_420_trace``.

They run on whatever device the band lies on. No hand kernel yet: this
stage is plain torch (ROADMAP.md lists its kernel as the next to write).
"""

from __future__ import annotations

import torch

from .jpeg_dct import band_to_blocks_islow, band_to_blocks_islow_420


def jpeg_quantize(band: torch.Tensor, luma_q: torch.Tensor, chroma_q: torch.Tensor):
    """YCbCr + FDCT + quantize of a (H, W, >=3) uint8 band, H and W
    multiples of 8. Returns (y, cb, cr), each (H/8 * W/8, 64) int16
    natural-order blocks, strip-major."""
    return band_to_blocks_islow(band, luma_q, chroma_q)


def jpeg_quantize_420(band: torch.Tensor, luma_q: torch.Tensor, chroma_q: torch.Tensor):
    """4:2:0 quantize of a (16k, W, >=3) uint8 band with W % 16 == 0.
    Returns (y (4n, 64) in MCU order [TL, TR, BL, BR], cb (n, 64),
    cr (n, 64)) int16, n MCUs raster-major."""
    return band_to_blocks_islow_420(band, luma_q, chroma_q)
