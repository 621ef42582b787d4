"""The torch port's mesh and fused grid steps beside the JAX package's.

The cases of tests/unit/test_parallel_mesh.py: the JAX side runs on its
8-device CPU mesh (tests/conftest.py), the port's on
``make_mesh(n, device="cpu")``, n virtual shards of the CPU. The fused and
sharded PNG, JPEG and dual steps must give the JAX steps' arrays exactly,
on the same seeded tiles. Then what the port adds: ``row_slabs`` at its
edges, the refusals of ``make_mesh`` and ``Mesh``, and ``dryrun_multichip``
(the port's copy of ``__graft_entry__.dryrun_multichip``'s byte checks).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_stitch_tpu.codecs.jpeg.tables import quality_scaled_tables
from image_stitch_tpu.ops import fused as jax_fused
from image_stitch_tpu.parallel import mesh as jax_mesh
from image_stitch_tpu_torch.errors import StitchError
from image_stitch_tpu_torch.ops import fused
from image_stitch_tpu_torch.parallel import mesh

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


def tiles_fixture(gy=2, gx=8, th=16, tw=16, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (gy, gx, th, tw, 4), dtype=np.uint8)


def qtables():
    lq, cq = quality_scaled_tables(85)
    return (torch.from_numpy(lq), torch.from_numpy(cq)), (jnp.asarray(lq), jnp.asarray(cq))


def same(port_out, jax_out) -> None:
    assert len(port_out) == len(jax_out)
    for a, b in zip(port_out, jax_out):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [1, 4, 6, 8])
def test_mesh_factorization(n):
    port_mesh = mesh.make_mesh(n, device="cpu")
    ref = jax_mesh.make_mesh(n)
    assert port_mesh.shape == dict(ref.shape)
    assert port_mesh.axis_names == ref.axis_names == ("band", "x")
    assert port_mesh.devices.shape == ref.devices.shape
    assert port_mesh.size == ref.devices.size == n
    assert port_mesh.flat() == [torch.device("cpu")] * n
    one_axis = mesh.make_mesh(n, axes=("band",), device="cpu")
    assert one_axis.shape == dict(jax_mesh.make_mesh(n, axes=("band",)).shape) == {"band": n}


def test_assemble_uniform_grid_layout():
    tiles = tiles_fixture(2, 4, 8, 8, 1)
    canvas = fused.assemble_uniform_grid(torch.from_numpy(tiles))
    assert canvas.shape == (16, 32, 4)
    np.testing.assert_array_equal(canvas[0:8, 8:16].numpy(), tiles[0, 1])
    np.testing.assert_array_equal(canvas[8:16, 24:32].numpy(), tiles[1, 3])
    np.testing.assert_array_equal(
        canvas.numpy(), np.asarray(jax_fused.assemble_uniform_grid(jnp.asarray(tiles))))


def test_sharded_png_step_matches_single_device():
    tiles = tiles_fixture()
    prev = np.zeros(8 * 16 * 4, np.uint8)
    t, p = torch.from_numpy(tiles), torch.from_numpy(prev)
    sharded = mesh.shard_grid_png_step(mesh.make_mesh(8, device="cpu"))(t, p)
    local = fused.fused_grid_png_step(t, p)
    jax_local = jax.jit(jax_fused.fused_grid_png_step)(jnp.asarray(tiles), jnp.asarray(prev))
    jax_sharded = jax_mesh.shard_grid_png_step(jax_mesh.make_mesh(8))(
        jnp.asarray(tiles), jnp.asarray(prev))
    same(sharded, jax_sharded)
    same(local, jax_local)
    assert sharded[0].dtype == torch.int32


def test_sharded_jpeg_step_matches_single_device():
    tiles = tiles_fixture(seed=2)
    (lq, cq), (jlq, jcq) = qtables()
    t = torch.from_numpy(tiles)
    sharded = mesh.shard_grid_jpeg_step(mesh.make_mesh(8, device="cpu"))(t, lq, cq)
    local = fused.fused_grid_jpeg_step(t, lq, cq)
    jax_local = jax.jit(jax_fused.fused_grid_jpeg_step)(jnp.asarray(tiles), jlq, jcq)
    jax_sharded = jax_mesh.shard_grid_jpeg_step(jax_mesh.make_mesh(8))(
        jnp.asarray(tiles), jlq, jcq)
    same(sharded, jax_sharded)
    same(local, jax_local)


def test_sharded_dual_step_runs_on_2d_mesh():
    out = mesh.run_multichip_demo(8, gy=2, gx=8, th=16, tw=16, device="cpu")
    ftypes, filtered, last, yb, cbb, crb = out
    assert filtered.shape == (2 * 16, 8 * 16 * 4)
    assert yb.shape[1] == 64
    same(out, jax_mesh.run_multichip_demo(8, gy=2, gx=8, th=16, tw=16))
    # And the dual step on one device, on the demo's own tiles.
    tiles = tiles_fixture(2, 8, 16, 16, 0)
    (lq, cq), _ = qtables()
    local = fused.fused_grid_dual_step(torch.from_numpy(tiles),
                                       torch.zeros(8 * 16 * 4, dtype=torch.uint8), lq, cq)
    same(local, out)


def test_sharded_on_subset_of_devices():
    # Meshes smaller than the shard count must also work (2x2).
    tiles = tiles_fixture(2, 4, 8, 8, 3)
    prev = np.zeros(4 * 8 * 4, np.uint8)
    sharded = mesh.shard_grid_png_step(mesh.make_mesh(4, device="cpu"))(
        torch.from_numpy(tiles), torch.from_numpy(prev))
    jax_sharded = jax_mesh.shard_grid_png_step(jax_mesh.make_mesh(4))(
        jnp.asarray(tiles), jnp.asarray(prev))
    local = jax.jit(jax_fused.fused_grid_png_step)(jnp.asarray(tiles), jnp.asarray(prev))
    np.testing.assert_array_equal(sharded[1].numpy(), np.asarray(local[1]))
    same(sharded, jax_sharded)


@pytest.mark.parametrize("n", [6, 8])
def test_multichip_demo_scales_tile_grid_to_mesh(n):
    """The demo's tile grid is divided by whatever (band, x) factoring
    make_mesh picks (n=6 is (2, 3)), in both packages, over the same tiles."""
    out = mesh.run_multichip_demo(n, gy=2, gx=8, th=16, tw=16, device="cpu")
    same(out, jax_mesh.run_multichip_demo(n, gy=2, gx=8, th=16, tw=16))


@pytest.mark.parametrize("h,n,align,want", [
    (3, 8, 1, [(0, 1), (1, 2), (2, 3)] + [(3, 3)] * 5),
    (0, 4, 1, [(0, 0)] * 4),
    (37, 4, 1, [(0, 10), (10, 19), (19, 28), (28, 37)]),
    (40, 4, 8, [(0, 16), (16, 24), (24, 32), (32, 40)]),
    (20, 4, 8, [(0, 8), (8, 16), (16, 20), (20, 20)]),
    (48, 8, 16, [(0, 16), (16, 32), (32, 48)] + [(48, 48)] * 5),
    (10, 2, 16, [(0, 10), (10, 10)]),
])
def test_row_slabs(h, n, align, want):
    """Consecutive runs of whole align-row units, as even as they allow,
    the first shards taking one more; fewer units than shards leaves the
    trailing shards empty; a band that ends mid-unit cuts the last one."""
    got = mesh.row_slabs(h, n, align)
    assert got == want
    assert got[0][0] == 0 and got[-1][1] == h
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))
    assert all(r0 % align == 0 for r0, r1 in got if r1 > r0)


def test_make_mesh_refuses_what_is_not_there(monkeypatch):
    with pytest.raises(StitchError, match="devices"):
        mesh.make_mesh(mesh.CPU_SHARDS + 1, device="cpu")
    with pytest.raises(StitchError, match="devices"):
        mesh.make_mesh(64, device="cpu")
    assert mesh.make_mesh(device="cpu").size == mesh.CPU_SHARDS
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(StitchError, match="devices"):
        mesh.make_mesh(1, device="cuda")


def test_mesh_objects():
    virtual = mesh.Mesh([["cpu", "cpu"], ["cpu", "cpu"]])
    assert virtual.shape == {"band": 2, "x": 2} and virtual.size == 4
    assert virtual.distinct() == [torch.device("cpu")]
    with virtual.shard(3) as dev:
        assert dev == torch.device("cpu")
    with pytest.raises(StitchError, match="all be cuda or all cpu"):
        mesh.Mesh([["cpu", "cuda:0"]])
    with pytest.raises(StitchError):
        mesh.Mesh(np.empty((0, 0), dtype=object))


def test_sharded_band_rows():
    """A band in slabs gives any rows on a device: a view inside one slab,
    the pieces joined across slabs."""
    full = torch.arange(10 * 3 * 4, dtype=torch.int32).to(torch.uint8).reshape(10, 3, 4)
    band = mesh.ShardedBand([(0, full[:4].clone()), (4, full[4:5].clone()),
                             (5, full[5:].clone())])
    assert band.shape == (10, 3, 4) and band.dtype == torch.uint8 and band.ndim == 3
    cpu = torch.device("cpu")
    inside = band.rows(1, 3, cpu)
    assert inside.data_ptr() == band.slabs[0][1][1].data_ptr()
    for r0, r1 in ((0, 10), (3, 6), (4, 5), (9, 10)):
        np.testing.assert_array_equal(band.rows(r0, r1, cpu).numpy(), full[r0:r1].numpy())
        np.testing.assert_array_equal(mesh.band_rows(full.numpy(), r0, r1, cpu).numpy(),
                                      full[r0:r1].numpy())
    np.testing.assert_array_equal(band.cpu().numpy(), full.numpy())


@pytest.mark.parametrize("n", [3, 8])
def test_dryrun_multichip(n, capsys):
    """The port's copy of the graft entry's byte checks: the sharded dual
    step, then grid -> PNG, -> JPEG with restart rows 1 and the northstar
    shape over the mesh, each equal to the host tier."""
    mesh.dryrun_multichip(n, device="cpu")
    assert f"{n}-device mesh, sharded == host bytes" in capsys.readouterr().out
