"""Bytes the JPEG-tile device decode must move, for its roofline.

A band of JPEG tiles decoded on the card reads the tiles' quantized
coefficients and writes the band's RGBA pixels. Over a job:

- in, the job's ``JobSpec.input_bytes``: what the kind counts of tiles the
  card decodes, the quantized coefficients, 2 bytes each, 64 a block
  (``kinds/grid.input_bytes``);
- out, the canvas's RGBA pixels, H x W x 4 bytes.

Intermediates are not counted: the dequantized blocks, the IDCT's output
planes between ``idct_dequant`` and ``ycc_rgba``, and the staged tables.
An ideal decode keeps them on chip, so the count reads the same work
whatever kernels implement it. The quantizer tables are a few hundred
bytes a band and are left out too.
"""

from __future__ import annotations

# Substrings of the device operations of the decode's two kernels
# (csrc/idct.cu, csrc/ycc.cu).
DECODE_KERNELS = ("idct_dequant", "ycc_rgba")


def decode_bytes(spec) -> int:
    """A job's coefficients in and its canvas's RGBA out."""
    h, w = spec.canvas
    return spec.input_bytes + h * w * 4


def kernel_seconds(device_ops) -> float | None:
    """The summed device time of the decode's two kernels among
    ``device_ops`` ((name, seconds) pairs); None unless both are there."""
    ops = list(device_ops)
    if not all(any(k in name for name, _ in ops) for k in DECODE_KERNELS):
        return None
    return sum(s for name, s in ops if any(k in name for k in DECODE_KERNELS))
