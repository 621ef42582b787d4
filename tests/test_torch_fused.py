"""The fused uniform-grid step (``ops.kernels.grid_dual``) beside the JAX
package's, and the names the port took from ``image_stitch_tpu/core.py`` and
``JaxBackend``.

Each case is a tile stack made from a numpy seed (``testing.grid_tiles``:
tiles whose rows pick every PNG filter). Three versions of the port's step
must give the JAX package's ``fused_grid_png_step``, ``_jpeg_step`` and
``_dual_step`` arrays exactly (every output is an integer, so the tolerance
is zero), the JAX side on ``JAX_PLATFORMS=cpu`` as tests/test_torch_mesh.py
runs it: the port's steps on CPU tensors (``grid_dual_plain``), the
composition they replace (``fused_grid_*_step_plain``), and the kernel's own
addressing, split and reduction in the serial host shim
(csrc/host_shim.cpp ``grid_dual_host``, built with g++). Then row ranges of
mesh slabs, an empty one included, and the wrapper's dispatch on shape.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_stitch_tpu import core as jax_core
from image_stitch_tpu.codecs.jpeg.tables import quality_scaled_tables
from image_stitch_tpu.ops import fused as jax_fused
from image_stitch_tpu.ops.device import JaxBackend
from image_stitch_tpu.parallel import mesh as jax_mesh
from image_stitch_tpu_torch import core
from image_stitch_tpu_torch._build import load_host_shim
from image_stitch_tpu_torch.ops import fused
from image_stitch_tpu_torch.ops import kernels as K
from image_stitch_tpu_torch.ops.counters import EncodeCounters
from image_stitch_tpu_torch.ops.device import TorchBackend
from image_stitch_tpu_torch.parallel import mesh
from image_stitch_tpu_torch.testing import grid_tiles

torch.set_num_threads(1)

# (gy, gx, th, tw): entry()'s shape (__graft_entry__.py); a tile height that
# cuts the 8-row strips; tiles of 10 pixels (40 B a tile row, so no 16 B
# copies); a width of two windows a CTA (1,100 px: 8 CTAs of 144); rows and
# a width off 8, for the PNG half alone.
SHAPES = {"entry": (2, 4, 64, 64), "strip_cut": (2, 3, 12, 40), "tw10": (2, 4, 8, 10),
          "two_windows": (1, 9, 8, 1100), "png_only": (3, 2, 7, 13)}


def tables():
    lq, cq = quality_scaled_tables(85)
    return (torch.from_numpy(lq), torch.from_numpy(cq)), (jnp.asarray(lq), jnp.asarray(cq))


def carry(w: int, kind: str, seed: int) -> np.ndarray:
    if kind == "zeros":
        return np.zeros(w * 4, np.uint8)
    return np.random.default_rng(seed).integers(0, 256, w * 4, dtype=np.uint8)


def shim_step(tiles: torch.Tensor, prev: torch.Tensor, lq, cq, r0: int, r1: int, png: bool,
              jpeg: bool) -> list[torch.Tensor]:
    """``grid_dual_host`` over rows [r0, r1): the kernel's split, serially."""
    gy, gx, th, tw, _ = tiles.shape
    w, rows = gx * tw, r1 - r0
    outs = [torch.zeros(rows, dtype=torch.int32), torch.zeros((rows, w * 4), dtype=torch.uint8),
            torch.zeros(w * 4, dtype=torch.uint8)]
    n = rows // 8 * (w // 8) if jpeg else 0
    outs += [torch.zeros((n, 64), dtype=torch.int16) for _ in range(3)]
    load_host_shim().grid_dual_host(
        tiles.data_ptr(), prev.data_ptr(), gx, th, tw, r0, r1, lq.data_ptr(), cq.data_ptr(),
        int(png), int(jpeg), *(t.data_ptr() for t in outs))
    return (outs[:3] if png else []) + (outs[3:] if jpeg else [])


def same(port_out, want) -> None:
    assert len(port_out) == len(want)
    for a, b in zip(port_out, want):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("prev_kind", ["zeros", "random"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_fused_steps_match_jax(name, prev_kind):
    gy, gx, th, tw = SHAPES[name]
    tiles = grid_tiles((gy, gx, th, tw), seed=len(name))
    prev = carry(gx * tw, prev_kind, gy * gx)
    t, p = torch.from_numpy(tiles), torch.from_numpy(prev)
    (lq, cq), (jlq, jcq) = tables()
    h = gy * th
    want_png = jax.jit(jax_fused.fused_grid_png_step)(jnp.asarray(tiles), jnp.asarray(prev))
    for port in (fused.fused_grid_png_step(t, p), fused.fused_grid_png_step_plain(t, p),
                 shim_step(t, p, lq, cq, 0, h, True, False)):
        same(port, want_png)
    assert len(set(want_png[0].tolist())) > 1  # the rows pick more than one filter
    if h % 8 or (gx * tw) % 8:
        return
    want_jpeg = jax.jit(jax_fused.fused_grid_jpeg_step)(jnp.asarray(tiles), jlq, jcq)
    for port in (fused.fused_grid_jpeg_step(t, lq, cq), fused.fused_grid_jpeg_step_plain(t, lq, cq),
                 shim_step(t, p, lq, cq, 0, h, False, True)):
        same(port, want_jpeg)
    want_dual = jax.jit(jax_fused.fused_grid_dual_step)(jnp.asarray(tiles), jnp.asarray(prev),
                                                        jlq, jcq)
    for port in (fused.fused_grid_dual_step(t, p, lq, cq),
                 fused.fused_grid_dual_step_plain(t, p, lq, cq),
                 shim_step(t, p, lq, cq, 0, h, True, True)):
        same(port, want_dual)
    assert fused.fused_grid_dual_step(t, p, lq, cq)[0].dtype == torch.int32


@pytest.mark.parametrize("name,shards,jpeg", [("entry", 3, True), ("entry", 24, True),
                                              ("strip_cut", 2, True), ("png_only", 4, False),
                                              ("png_only", 30, False)])
def test_row_ranges_of_mesh_slabs_match_jax(name, shards, jpeg):
    """Every slab of ``row_slabs`` (8-row strips with the JPEG half), the
    trailing empty ones included: rows [r0, r1) of the JAX step's outputs,
    the raw row r1 - 1 (the row above for an empty range); the row above a
    slab comes from the tiles, never from ``prev_row``."""
    gy, gx, th, tw = SHAPES[name]
    tiles = grid_tiles((gy, gx, th, tw), seed=shards)
    prev = carry(gx * tw, "random", shards)
    t, p = torch.from_numpy(tiles), torch.from_numpy(prev)
    (lq, cq), (jlq, jcq) = tables()
    h, w = gy * th, gx * tw
    canvas = np.asarray(jax_fused.assemble_uniform_grid(jnp.asarray(tiles))).reshape(h, w * 4)
    if jpeg:
        types, filtered, _, y, cb, cr = jax.jit(jax_fused.fused_grid_dual_step)(
            jnp.asarray(tiles), jnp.asarray(prev), jlq, jcq)
    else:
        types, filtered, _ = jax.jit(jax_fused.fused_grid_png_step)(jnp.asarray(tiles),
                                                                   jnp.asarray(prev))
    slabs = mesh.row_slabs(h, shards, 8 if jpeg else 1)
    assert any(r0 == r1 for r0, r1 in slabs) == (shards * (8 if jpeg else 1) > h)
    for r0, r1 in slabs:
        last = canvas[r1 - 1] if r1 else prev
        want = [np.asarray(types)[r0:r1], np.asarray(filtered)[r0:r1], last]
        if jpeg:
            bpr = w // 8
            want += [np.asarray(b)[r0 // 8 * bpr:r1 // 8 * bpr] for b in (y, cb, cr)]
        # The carry must not be read past the image's first row.
        prev_arg = p if r0 == 0 else torch.full_like(p, 7)
        same(K.grid_dual(t, prev_arg, lq, cq, r0, r1, True, jpeg), want)
        if r1 > r0:
            same(shim_step(t, prev_arg, lq, cq, r0, r1, True, jpeg), want)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_steps_match_jax(n):
    """The mesh steps, a grid_dual per non-empty slab, on shapes the mesh
    tests do not cover: the JAX package's single-device step."""
    gy, gx, th, tw = SHAPES["strip_cut"]
    tiles = grid_tiles((gy, gx, th, tw), seed=n)
    prev = carry(gx * tw, "random", n)
    t, p = torch.from_numpy(tiles), torch.from_numpy(prev)
    (lq, cq), (jlq, jcq) = tables()
    m = mesh.make_mesh(n, device="cpu")
    same(mesh.shard_grid_dual_step(m)(t, p, lq, cq),
         jax.jit(jax_fused.fused_grid_dual_step)(jnp.asarray(tiles), jnp.asarray(prev), jlq, jcq))
    same(mesh.shard_grid_png_step(m)(t, p),
         jax.jit(jax_fused.fused_grid_png_step)(jnp.asarray(tiles), jnp.asarray(prev)))


@pytest.mark.parametrize("tw,offset,variant", [(64, 0, "vec16"), (20, 0, "vec16"),
                                               (10, 0, "words"), (64, 4, "words"),
                                               (64, 1, "composition"), (10, 2, "composition")])
def test_dispatch_on_shape(tw, offset, variant):
    """``grid_dual_variant``: 16 B copies where a tile row's bytes and the
    addresses are multiples of 16, 4 B copies at multiples of 4, else the
    composition; each gives the JAX package's arrays."""
    shape = (2, 4, 8, tw)
    tiles = grid_tiles(shape, seed=tw + offset)
    store = torch.zeros(tiles.size + 16, dtype=torch.uint8)
    base = (-store.data_ptr()) % 16  # a 16 B boundary, then the offset
    t = store[base + offset:base + offset + tiles.size].view(*shape, 4)
    t.copy_(torch.from_numpy(tiles))
    prev = torch.zeros(4 * tw * 4, dtype=torch.uint8)
    assert K.GRID_DUAL_VARIANTS[K.grid_dual_variant(tw, t.data_ptr(), prev.data_ptr())] == variant
    (lq, cq), (jlq, jcq) = tables()
    same(fused.fused_grid_dual_step(t, prev, lq, cq),
         jax.jit(jax_fused.fused_grid_dual_step)(jnp.asarray(tiles), jnp.asarray(prev.numpy()),
                                                 jlq, jcq))


def test_grid_dual_refuses_what_it_does_not_take():
    tiles = torch.zeros((2, 2, 8, 12, 4), dtype=torch.uint8)
    prev = torch.zeros(2 * 12 * 4, dtype=torch.uint8)
    (lq, cq), _ = tables()
    with pytest.raises(ValueError, match="multiples of 8"):
        K.grid_dual(tiles, prev, lq, cq, 0, 12)
    with pytest.raises(ValueError, match="outside"):
        K.grid_dual(tiles, prev, lq, cq, 8, 24)
    with pytest.raises(TypeError):
        K.grid_dual(tiles[..., :3].contiguous(), prev, lq, cq)
    with pytest.raises(ValueError, match="prev_row has"):
        K.grid_dual(tiles, prev[:-4], None, None, jpeg=False)


# --------------------------------------------------- concat_core, backend --- #


def _png(rgba: np.ndarray) -> bytes:
    import zlib

    from image_stitch_tpu_torch.codecs.png.writer import build_png
    from image_stitch_tpu_torch.types import PngHeader

    h, w, _ = rgba.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgba.reshape(h, -1)], axis=1)
    return build_png(PngHeader(width=w, height=h, bit_depth=8, color_type=6),
                     zlib.compress(raw.tobytes()))


@pytest.mark.parametrize("fmt", ["png", "jpeg"])
def test_concat_core_matches_jax(fmt):
    rng = np.random.default_rng(len(fmt))
    tiles = [_png(rng.integers(0, 256, (24, 40, 4), dtype=np.uint8)) for _ in range(4)]
    opts = {"inputs": tiles, "layout": {"columns": 2}, "outputFormat": fmt, "bandHeight": 16,
            "jpegRestartIntervalRows": 1}
    want = jax_core.concat_core(opts)
    assert core.concat_core(opts, device="cpu") == want
    chunks = core.concat_streaming_core(opts, device="cpu")
    assert not isinstance(chunks, (bytes, list))
    assert b"".join(chunks) == b"".join(jax_core.concat_streaming_core(opts)) == want


@pytest.mark.parametrize("shards", [None, 3, 4])
@pytest.mark.parametrize("h,w", [(8, 40), (32, 64), (48, 24)])
def test_jpeg_quantize_band_matches_jax_backend(h, w, shards):
    """``TorchBackend``'s JPEG quantize against ``JaxBackend``'s, alone and
    over a CPU mesh (the JAX side on a mesh of as many devices): the band
    given as a host array and as a tensor; async then wait; the strip form."""
    rng = np.random.default_rng(h + w)
    band = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    band[: h // 2, : w // 2, :3] = (0, 0, 255)  # Cb = 256
    lq, cq = quality_scaled_tables(50)
    jax_backend = JaxBackend(mesh=None if shards is None else jax_mesh.make_mesh(shards))
    want = jax_backend.jpeg_quantize_band(band, lq, cq)
    counters = EncodeCounters()
    port = TorchBackend("cpu", counters,
                        mesh=None if shards is None else mesh.make_mesh(shards, device="cpu"))
    for got in (port.jpeg_quantize_band(band, lq, cq),
                port.jpeg_quantize_band_wait(port.jpeg_quantize_band_async(
                    torch.from_numpy(band), torch.from_numpy(lq), torch.from_numpy(cq))),
                port.jpeg_quantize_strip(band, lq, cq)):
        assert all(isinstance(g, np.ndarray) and g.dtype == np.int16 for g in got)
        same([torch.from_numpy(g) for g in got], want)
    slabs = sum(r1 > r0 for r0, r1 in mesh.row_slabs(h, shards or 1, 8))
    assert counters.mesh_slabs == (3 * slabs if shards else 0)



@pytest.mark.parametrize("w", [1, 8, 13, 40, 127, 128, 129, 256, 1000, 1024, 1100, 4096, 8192,
                               9000, 65536])
def test_grid_dual_ctas_matches_the_kernels_split(w):
    """The wrapper sizes the CTAs' exchange with ``grid_dual_ctas``: the
    same count as csrc/grid_dual.cuh, as the host shim builds it."""
    for rows in (1, 8, 9, 256):
        assert K.grid_dual_ctas(rows, w) == load_host_shim().grid_dual_ctas_host(rows, w)
