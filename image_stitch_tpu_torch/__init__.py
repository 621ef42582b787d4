"""image_stitch_tpu_torch — the image_stitch_tpu pipeline on PyTorch and CUDA.

A port of ``image_stitch_tpu`` (JAX on a TPU) to torch on an NVIDIA H100,
which lives beside it; the JAX package is the reference the port's tests
hold it to, byte for byte. Grid and positioned inputs go to JPEG or PNG
output (8-bit and 16-bit): host decode, layout, band assembly and deflate
are the JAX package's framework-free modules, imported as they are. On
``device`` run, in torch: JPEG quantize and entropy symbols (plain torch),
the phase-1 pack and the merge; PNG filter select; and the positioned
alpha compositing of 8-bit bands. The last four are hand-written CUDA
kernels (``csrc/``, built with nvcc for sm_90a on first use). The package
never imports jax.
"""

from __future__ import annotations

from image_stitch_tpu.errors import StitchError

from .api import concat_streaming, concat_to_buffer, concat_to_file
from .core import TorchStreamingConcatenator
from .ops.counters import EncodeCounters

__all__ = [
    "EncodeCounters",
    "StitchError",
    "TorchStreamingConcatenator",
    "concat_streaming",
    "concat_to_buffer",
    "concat_to_file",
]
