"""Pipeline "models": the deployable compute graphs of the port.

The counterpart of ``image_stitch_tpu/models/__init__.py``. This domain has
no neural models; its "model families" are its band programs, assembled
from ops/ the way a model is assembled from layers:

- :func:`fused_grid_dual_step`: PNG filter select and JPEG colour, FDCT
  and quantize of a uniform grid, one read of its tile stack (ops/fused.py,
  csrc/grid_dual.cu);
- :func:`entropy_pack_carried`: the JPEG band's entropy pack as one carried
  stream, the counterpart of ``entropy_pack_trace_v2``
  (ops/jpeg_entropy_device.py);
- :class:`TorchJpegEncoder`: the streaming band encoder, with its carry
  state on the device;
- the sharded forms over a ``("band", "x")`` mesh (parallel/mesh.py).

Not here: ``entropy_pack_trace``, the JAX package's v1 packer, which the
port does not carry (ROADMAP, "Not ported"); and ``jpeg_encode_band_trace``,
whose work the encoder's band program does in its kernels.
"""

from ..ops.device import jpeg_quantize
from ..ops.fused import (
    assemble_uniform_grid,
    fused_grid_dual_step,
    fused_grid_jpeg_step,
    fused_grid_png_step,
)
from ..ops.jpeg_entropy_device import TorchJpegEncoder, entropy_pack_carried
from ..ops.kernels import filter_select
from ..parallel.mesh import (
    make_mesh,
    shard_grid_dual_step,
    shard_grid_jpeg_step,
    shard_grid_png_step,
)

__all__ = [
    "assemble_uniform_grid",
    "fused_grid_dual_step",
    "fused_grid_jpeg_step",
    "fused_grid_png_step",
    "TorchJpegEncoder",
    "entropy_pack_carried",
    "filter_select",
    "jpeg_quantize",
    "make_mesh",
    "shard_grid_dual_step",
    "shard_grid_jpeg_step",
    "shard_grid_png_step",
]
