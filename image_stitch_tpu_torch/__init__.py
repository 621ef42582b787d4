"""image_stitch_tpu_torch — the image_stitch_tpu pipeline on PyTorch and CUDA.

A port of ``image_stitch_tpu`` (JAX on a TPU) to torch on an NVIDIA H100,
which lives beside it; the JAX package is the reference the port's tests
hold it to, byte for byte. Grid and positioned inputs (PNG, JPEG, HEIC
and arrays) go to JPEG or PNG output (8-bit and 16-bit): host decode,
layout, band assembly and deflate are the port's own copies of the JAX
package's framework-free modules, at the same paths. On
``device`` run hand-written CUDA kernels (``csrc/``, built with nvcc for
sm_90a on first use): for JPEG output, quantize, entropy symbols and the
entropy pack and merge; for JPEG tiles into JPEG output, the band decode
after the host's Huffman stage (dequantize and IDCT, upsampling and
colour); for PNG output, filter select; and the positioned alpha
compositing of 8-bit bands. The package imports nothing of jax or of
``image_stitch_tpu``.
"""

from __future__ import annotations

from .errors import StitchError

from .api import (
    StreamingConcatenator,
    concat,
    concat_arrays,
    concat_streaming,
    concat_to_buffer,
    concat_to_file,
    concat_to_stream,
)
from .codecs.heic import heic_plugin
from .codecs.jpeg.decoder import jpeg_plugin
from .codecs.png.decoder import png_plugin
from .codecs.registry import set_default_decoder_plugins
from .core import TorchStreamingConcatenator
from .ops.counters import EncodeCounters

# PNG, JPEG and HEIC inputs by default, as the JAX package registers them
# (reference src/index.ts:38-43).
set_default_decoder_plugins([png_plugin(), jpeg_plugin(), heic_plugin()])

__all__ = [
    "EncodeCounters",
    "StitchError",
    "StreamingConcatenator",
    "TorchStreamingConcatenator",
    "concat",
    "concat_arrays",
    "concat_streaming",
    "concat_to_buffer",
    "concat_to_file",
    "concat_to_stream",
]
