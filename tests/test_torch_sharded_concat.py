"""The torch port's mesh runs beside the JAX package's sharded runs.

Every case of tests/integration/test_sharded_concat.py with
``image_stitch_tpu_torch.concat_to_buffer({..., "mesh": n}, device="cpu")``
(n virtual shards of the CPU, the kernels' plain versions) against
``image_stitch_tpu.concat_to_buffer`` with ``mesh=n`` (its 8-device CPU
mesh, tests/conftest.py) and with ``backend="numpy"``, on the same inputs:
the bytes must be equal. Then the mesh cases that the JAX package tests
elsewhere: positioned compositing to PNG and JPEG
(tests/unit/test_composite_device.py), with sprites across the slabs'
edges; JPEG tiles through the device decode; 4:2:0 with a short last
restart group; 16-bit PNG; and ``mesh`` with ``backend="numpy"``, which
takes the mesh in both packages.
"""

import numpy as np
import pytest
import torch

import image_stitch_tpu
import image_stitch_tpu_torch
from image_stitch_tpu.parallel.mesh import make_mesh as jax_make_mesh
from image_stitch_tpu_torch.errors import StitchError
from image_stitch_tpu_torch.parallel.mesh import Mesh, make_mesh, row_slabs
from tests.utils.fixtures import decode_png_pil, jpeg_from_array, png_from_array

torch.set_num_threads(1)


def noisy_tile(seed: int, w: int = 96, h: int = 80) -> np.ndarray:
    """tests/integration/test_sharded_concat.py's tile."""
    r = np.random.default_rng(seed)
    x = np.linspace(0, 255, w).astype(np.uint8)
    a = np.zeros((h, w, 4), np.uint8)
    a[:, :, 0] = x[None, :]
    a[:, :, 1] = seed * 37 % 256
    a[:, :, 2] = x[None, ::-1]
    a[:, :, 3] = 255
    return (a.astype(np.int16) + r.integers(-10, 11, a.shape)).clip(0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def tiles():
    return [png_from_array(noisy_tile(i)) for i in range(4)]


def port(opts: dict, counters=None) -> bytes:
    return image_stitch_tpu_torch.concat_to_buffer(opts, device="cpu", counters=counters)


def same_three_ways(opts: dict, mesh, jax_mesh=None, counters=None) -> bytes:
    """The port's bytes over ``mesh`` equal the JAX package's over
    ``jax_mesh`` (``mesh`` when it is an int) and its host tier's; returns
    them."""
    got = port({**opts, "mesh": mesh}, counters)
    want = image_stitch_tpu.concat_to_buffer(
        {**opts, "mesh": mesh if jax_mesh is None else jax_mesh})
    assert got == want
    assert got == image_stitch_tpu.concat_to_buffer({**opts, "backend": "numpy"})
    return got


def grid(tiles, **extra) -> dict:
    return {"inputs": tiles, "layout": {"columns": 2}, "bandHeight": 48, **extra}


def test_sharded_png_bytes_match_jax_and_host(tiles):
    counters = image_stitch_tpu_torch.EncodeCounters()
    same_three_ways(grid(tiles), 8, counters=counters)
    # 160 rows in bands of 48, 48, 48, 16: 8 + 8 + 8 + 8 slabs of rows.
    assert counters.png_bands == 4 and counters.mesh_slabs == 32
    assert counters.host_tier_bands == 0


def test_sharded_jpeg_bytes_match_jax_and_host(tiles):
    """Restart rows 0: the carried stream stays on the mesh's first shard."""
    counters = image_stitch_tpu_torch.EncodeCounters()
    same_three_ways(grid(tiles, outputFormat="jpeg"), 8, counters=counters)
    assert counters.mesh_dispatches == counters.bands == 4


@pytest.mark.parametrize("ri", [1, 2])
def test_sharded_jpeg_restart_groups_match_jax_and_host(tiles, ri):
    """Restart groups dealt over the shards, byte-aligned and DC-reset,
    give the sequential coder's bytes."""
    counters = image_stitch_tpu_torch.EncodeCounters()
    same_three_ways(grid(tiles, outputFormat="jpeg", jpeg_restart_interval_rows=ri), 8,
                    counters=counters)
    groups_per_band = [-(-h // (8 * ri)) for h in (48, 48, 48, 16)]
    assert counters.mesh_dispatches == sum(min(g, 8) for g in groups_per_band)


def test_sharded_output_decodes_correctly(tiles):
    """Independent oracle: PIL's decode of the sharded PNG is the mosaic."""
    arr = decode_png_pil(port({**grid(tiles), "mesh": 8}))
    top = np.concatenate([noisy_tile(0), noisy_tile(1)], axis=1)
    bot = np.concatenate([noisy_tile(2), noisy_tile(3)], axis=1)
    np.testing.assert_array_equal(arr, np.concatenate([top, bot], axis=0))


def test_mesh_accepts_mesh_object(tiles):
    same_three_ways(grid(tiles), make_mesh(4, device="cpu"), jax_make_mesh(4))


def test_mesh_object_of_another_device_kind_raises(tiles):
    with pytest.raises(StitchError, match="mesh on cuda devices"):
        port({**grid(tiles), "mesh": Mesh([["cuda:0"]])})
    with pytest.raises(StitchError, match="mesh must be an int or a Mesh"):
        port({**grid(tiles), "mesh": "2"})


@pytest.mark.parametrize("extra", [{}, {"outputFormat": "jpeg", "jpegRestartIntervalRows": 1}])
def test_mesh_uneven_band_height(tiles, extra):
    """Bands that no mesh axis divides: the slabs are unequal, with no
    padding; to JPEG, rows held back between bands join the next one."""
    same_three_ways(grid(tiles, bandHeight=37, **extra), 8)


def test_mesh_x_indivisible_row_bytes():
    """97-px rows on a mesh of 3, bands of 29."""
    t = png_from_array(noisy_tile(9, w=97, h=41))
    same_three_ways({"inputs": [t], "layout": {"columns": 1}, "bandHeight": 29}, 3)


def test_mesh_oversubscription_rejected(tiles):
    with pytest.raises(StitchError, match="devices"):
        port({**grid(tiles), "mesh": 64})
    with pytest.raises(image_stitch_tpu.StitchError, match="devices"):
        image_stitch_tpu.concat_to_buffer({**grid(tiles), "mesh": 64})


def test_mesh_sharded_matches_single_device_at_q100(tiles):
    """q100 exposes every quantization rounding boundary."""
    opts = grid(tiles, outputFormat="jpeg", jpegQuality=100, jpeg_restart_interval_rows=1)
    got = same_three_ways(opts, 8)
    assert got == port(opts)


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4, 8])
def test_sharded_png_exact_on_full_range_noise(n_dev):
    rng = np.random.default_rng(123)
    arrs = [rng.integers(0, 256, (128, 128, 4), dtype=np.uint8) for _ in range(4)]
    same_three_ways({"inputs": arrs, "layout": {"columns": 2}}, n_dev)


def test_mesh_with_host_threads_bytes_match(tiles):
    """The mesh composes with the host_threads decode and deflate pool."""
    got = port({**grid(tiles), "mesh": 8, "hostThreads": 4})
    assert got == image_stitch_tpu.concat_to_buffer({**grid(tiles), "backend": "numpy"})
    assert got == image_stitch_tpu.concat_to_buffer({**grid(tiles), "mesh": 8, "hostThreads": 4})


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_mesh_sizes_png_bytes_match_jax_and_host(tiles, n_dev):
    same_three_ways(grid(tiles), n_dev)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_mesh_sizes_jpeg_restart_groups_match_jax_and_host(tiles, n_dev):
    same_three_ways(grid(tiles, outputFormat="jpeg", jpegRestartIntervalRows=1), n_dev)


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4, 8])
def test_sharded_jpeg_exact_on_full_range_noise(n_dev):
    """Full-range noise and a saturated checkerboard, restart rows 1."""
    rng = np.random.default_rng(321)
    arrs = [rng.integers(0, 256, (96, 96, 4), dtype=np.uint8) for _ in range(3)]
    sat = np.zeros((96, 96, 4), np.uint8)
    sat[..., 0] = 255
    sat[..., 2] = (rng.integers(0, 2, (96, 96)) * 255).astype(np.uint8)
    sat[..., 3] = 255
    arrs.append(sat)
    same_three_ways({"inputs": arrs, "layout": {"columns": 2}, "outputFormat": "jpeg",
                     "jpeg_restart_interval_rows": 1}, n_dev)


def test_northstar_shape_sharded_streaming_bytes():
    """The flagship's shape scaled down: a 16-column grid of 64-px tiles, 80
    rows of them, streamed to JPEG with restart groups over the 8-shard
    mesh in bands of 128 rows (40 bands)."""
    grid_n, tile, rows = 16, 64, 80
    t = [png_from_array(noisy_tile(i, w=tile, h=tile)) for i in range(4)]
    common = {
        "inputs": [t[i % 4] for i in range(grid_n * rows)], "layout": {"columns": grid_n},
        "outputFormat": "jpeg", "jpegQuality": 85, "jpeg_restart_interval_rows": 1,
        "bandHeight": 128,
    }
    counters = image_stitch_tpu_torch.EncodeCounters()
    got = b"".join(image_stitch_tpu_torch.concat_streaming({**common, "mesh": 8}, device="cpu",
                                                           counters=counters))
    assert got == b"".join(image_stitch_tpu.concat_streaming({**common, "backend": "numpy"}))
    assert got == b"".join(image_stitch_tpu.concat_streaming({**common, "mesh": 8}))
    assert counters.bands == 40 and counters.mesh_dispatches == 40 * 8


# ----------------------------------------------- what JAX tests elsewhere --- #


def sprite(seed: int, w: int, h: int) -> bytes:
    """tests/unit/test_composite_device.py:111-117's sprite: random RGBA with
    an alpha ramp."""
    import io

    from PIL import Image

    a = np.random.default_rng(seed).integers(0, 256, (h, w, 4), dtype=np.uint8)
    a[:, :, 3] = np.linspace(20, 240, w).astype(np.uint8)[None, :]
    buf = io.BytesIO()
    Image.fromarray(a, "RGBA").save(buf, "PNG")
    return buf.getvalue()


SPRITES = [((1, 100, 80), 0, 0, 0), ((2, 60, 50), 20, 10, 2), ((3, 40, 70), 50, 5, 1)]


def crosses_a_slab_edge(band: int, n: int, align: int) -> bool:
    """Whether some sprite of SPRITES covers rows on both sides of a slab
    edge inside a band (bands of ``band`` rows over the 80-row canvas)."""
    edges = {b0 + r0 for b0 in range(0, 80, band)
             for r0, r1 in row_slabs(min(band, 80 - b0), n, align) if 0 < r0 and r1 > r0}
    return any(y < e < y + h for (_, _, h), _, y, _ in SPRITES for e in edges)


@pytest.mark.parametrize("fmt,ri,band", [("png", 0, 24), ("jpeg", 0, 24), ("jpeg", 1, 24),
                                         ("jpeg", 1, 20)])
def test_sharded_positioned_matches_jax_and_host(fmt, ri, band):
    """Compositing on the shards, each slab blended with the sprites clipped
    to it and handed to the encoder where it lies (or, for bands of 20 rows,
    which are not whole restart groups, joined on the first shard)."""
    inputs = [{"source": sprite(*spec), "x": x, "y": y, "z_index": z}
              for spec, x, y, z in SPRITES]
    opts = {"inputs": inputs, "bandHeight": band, "outputFormat": fmt,
            "jpeg_restart_interval_rows": ri}
    align = 1 if fmt == "png" else 8 * max(1, ri)
    assert crosses_a_slab_edge(band, 8, align)
    counters = image_stitch_tpu_torch.EncodeCounters()
    same_three_ways(opts, 8, counters=counters)
    assert counters.composite_bands_on_device + counters.composite_fallback_bands == -(-80 // band)
    assert counters.composite_bands_on_device > 0


def test_sharded_positioned_ties_and_bands_as_arrays():
    """Random alpha with exact rational ties: the tied bands replay on the
    host, the rest blend on the shards; stream_bands gives host arrays."""
    from image_stitch_tpu.core import CoreStreamingConcatenator
    from tests.test_torch_slice import positioned_inputs

    opts = {"inputs": positioned_inputs(), "bandHeight": 32, "outputFormat": "png"}
    counters = image_stitch_tpu_torch.EncodeCounters()
    same_three_ways(opts, 4, counters=counters)
    assert counters.composite_bands_on_device > 0 and counters.composite_fallback_bands > 0
    got = list(image_stitch_tpu_torch.TorchStreamingConcatenator(
        {**opts, "mesh": 4}, device="cpu").stream_bands())
    ref = list(CoreStreamingConcatenator({**opts, "backend": "numpy"}).stream_bands())
    assert all(type(b) is np.ndarray for b in got) and len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ri", [0, 1])
def test_sharded_jpeg_tiles_decoded_on_the_first_device(ri):
    """JPEG tiles decode on the mesh's first device and each shard takes its
    rows of the band from there."""
    rng = np.random.default_rng(5)
    arrs = [(rng.integers(0, 256, (64, 48, 3)) // 32 * 32).astype(np.uint8) for _ in range(4)]
    opts = {"inputs": [jpeg_from_array(a) for a in arrs], "layout": {"columns": 2},
            "outputFormat": "jpeg", "bandHeight": 32, "jpegRestartIntervalRows": ri}
    counters = image_stitch_tpu_torch.EncodeCounters()
    same_three_ways(opts, 4, counters=counters)
    assert counters.decode_bands_on_device == 4
    assert counters.mesh_dispatches == (4 if ri == 0 else 4 * 4)


@pytest.mark.parametrize("sampling,h,ri", [("444", 88, 4), ("420", 112, 3)])
def test_sharded_tail_groups_match_jax_and_host(sampling, h, ri):
    """A last restart group shorter than the rest goes to the first shard."""
    from tests.test_torch_slice import make_image

    pngs = [png_from_array(make_image(96, h, seed=s)) for s in range(2)]
    opts = {"inputs": pngs, "layout": {"columns": 2}, "outputFormat": "jpeg",
            "jpegSampling": sampling, "jpegRestartIntervalRows": ri, "bandHeight": 32}
    same_three_ways(opts, 3)


def test_sharded_png16_matches_jax_and_host():
    rng = np.random.default_rng(16)
    pngs = [png_from_array(rng.integers(0, 65536, (37, 45, 4)).astype(np.uint16), bit_depth=16)
            for _ in range(2)]
    same_three_ways({"inputs": pngs, "layout": {"columns": 2}, "bandHeight": 16}, 3)


@pytest.mark.parametrize("fmt", ["png", "jpeg"])
def test_mesh_takes_the_band_programs_under_backend_numpy(tiles, fmt):
    """A mesh sends the band programs to the mesh whatever ``backend`` says,
    as in the JAX package: no band on the host tier."""
    opts = grid(tiles, outputFormat=fmt, backend="numpy", jpegRestartIntervalRows=1)
    counters = image_stitch_tpu_torch.EncodeCounters()
    got = port({**opts, "mesh": 4}, counters)
    assert got == image_stitch_tpu.concat_to_buffer({**opts, "mesh": 4})
    assert got == image_stitch_tpu.concat_to_buffer(opts)
    assert counters.host_tier_bands == 0
    assert (counters.mesh_slabs if fmt == "png" else counters.mesh_dispatches) > 0
