"""The traffic generator: deterministic from the seed, distinct bytes per
job, unique tiles within a job, any rows of a tile on demand."""

from __future__ import annotations

import zlib

import numpy as np
import pytest

from conftest import SEED, tiny_cell


def test_rows_of_a_tile_on_demand():
    from stitchbench.common.tiles import photo_rows

    whole = photo_rows(SEED, 3, 40, 48)
    assert whole.shape == (40, 48, 4) and (whole[..., 3] == 255).all()
    assert np.array_equal(photo_rows(SEED, 3, 40, 48, 13, 29), whole[13:29])
    assert not np.array_equal(photo_rows(SEED, 4, 40, 48), whole)
    assert not np.array_equal(photo_rows(SEED + 1, 3, 40, 48), whole)


def inputs(cell, state, j):
    return cell.traffic.job(SEED, state, j).options["inputs"]


def test_tiles_and_jobs_are_deterministic_from_the_seed(pool):
    from stitchbench.kinds import grid

    cell = tiny_cell("jpeg_q85.mosaic_10k")
    p = cell.traffic.params
    tiles = cell.traffic.make_state(SEED, pool)
    assert tiles == cell.traffic.make_state(SEED, pool)
    assert tiles != cell.traffic.make_state(SEED + 1, pool)
    assert inputs(cell, tiles, 5) == inputs(cell, tiles, 5)
    a, b = cell.traffic.job(SEED, None, 5).spec, cell.traffic.job(SEED, tiles, 5).spec
    assert a.canvas == b.canvas and a.input_bytes == b.input_bytes and a.rows[0] == b.rows[0]
    assert np.array_equal(a.rows[1][3], b.rows[1][3])
    assert list(grid.order(SEED, p, 0)) != list(grid.order(SEED, p, 1)) or \
        list(grid.order(SEED, p, 1)) != list(grid.order(SEED, p, 2))


def test_no_two_jobs_hand_the_same_bytes_and_tiles_are_unique(pool):
    from stitchbench.kinds import grid

    cell = tiny_cell("png_l6.mosaic_10k")
    tiles = cell.traffic.make_state(SEED, pool)
    seen = set()
    for j in range(4):
        job_inputs = inputs(cell, tiles, j)
        order = grid.order(SEED, cell.traffic.params, j)
        assert len(set(order.tolist())) == len(order) == cell.traffic.params["grid"]["tiles_per_job"]
        assert len(set(job_inputs)) == len(job_inputs)
        for b in job_inputs:
            assert b not in seen
            seen.add(b)


def test_png_tiles_hold_the_pixels_losslessly(pool):
    from stitchbench.common.tiles import photo_rows
    from stitchbench.reference import png as ref_png

    cell = tiny_cell("png_l6.mosaic_10k")
    tiles = cell.traffic.make_state(SEED, pool)
    tagged = inputs(cell, tiles, 0)[0]
    kinds = [k for k, _, ok in ref_png.chunks(tagged) if ok]
    assert kinds[:3] == [b"IHDR", b"tEXt", b"IDAT"] and kinds[-1] == b"IEND"
    assert np.array_equal(ref_png.decode(tiles[2]), photo_rows(SEED, 2, 40, 48))
    idat = [d for k, d, _ in ref_png.chunks(tiles[2]) if k == b"IDAT"]
    assert len(zlib.decompress(b"".join(idat))) == 40 * (1 + 48 * 4)


def test_the_spec_rebuilds_the_canvas_rows(pool):
    """A job's spec names the reference's rows; any range of them equals
    the same rows of the whole canvas."""
    from stitchbench.common.traffic import canvas_rows

    spec = tiny_cell("png_l6.mosaic_10k").traffic.job(SEED, None, 3).spec
    whole = canvas_rows(spec.rows, 0, spec.canvas[0])
    assert whole.shape == (*spec.canvas, 4)
    assert np.array_equal(canvas_rows(spec.rows, 17, 61), whole[17:61])
    with pytest.raises(ValueError):
        canvas_rows(("os:getcwd", ()), 0, 1)


def test_sizes_of_the_cells():
    from stitchbench.common.manifest import Cell
    from stitchbench.common.traffic import Traffic

    from conftest import ROOT

    mosaic = Cell.load(ROOT, "jpeg_q85.mosaic_10k")
    spec = mosaic.traffic.job(SEED, None, 0).spec
    assert spec.canvas == (10000, 10000) and spec.megapixels == 100.0
    assert spec.bands(mosaic.options["bandHeight"]) == 40
    assert spec.input_bytes == 400_000_000
    tiles = Traffic.load(ROOT / "stitchbench" / "traffic" / "jpeg_tiles.json")
    spec = tiles.job(SEED, None, 0).spec
    assert spec.canvas == (4096, 4096) and tiles.params["tiles"]["format"] == "jpeg"
    assert spec.input_bytes == 16 * (16384 + 2 * 4096) * 128
