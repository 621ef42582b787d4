"""Grid mosaics: unique tiles of one size in a grid, row-major.

Parameters (``traffic/<mix>.json``, ``"kind": "grid"``):

- ``tiles``: ``count`` unique tiles of ``width`` x ``height``, their
  ``format`` ("png", with zlib ``png_level``; or "jpeg", with
  ``jpeg_quality`` and ``jpeg_sampling``), made from the run's seed by the
  reference's own encoders, in parallel on the pool's workers;
- ``grid``: ``columns`` and ``tiles_per_job`` (whole grid rows).

Job ``j`` places ``tiles_per_job`` tiles of the pool, each once, in an
order drawn from (seed, j), and gives each a per-job ancillary chunk (PNG
``tEXt``, JPEG COM), so that no two jobs hand the program byte-identical
inputs. The reference rebuilds the canvas with ``reference/layout.py``.
"""

from __future__ import annotations

import math

import numpy as np

from stitchbench.common.tiles import photo_rows
from stitchbench.common.traffic import Job, JobSpec, tag
from stitchbench.reference import jpeg as ref_jpeg
from stitchbench.reference import png as ref_png


def make_tile(seed: int, tiles: dict, tile: int) -> bytes:
    """One tile's file (a pool task)."""
    rgba = photo_rows(seed, tile, tiles["height"], tiles["width"])
    if tiles["format"] == "png":
        return ref_png.encode(rgba, tiles["png_level"])
    if tiles["format"] == "jpeg":
        return ref_jpeg.encode(rgba, tiles["jpeg_quality"], tiles["jpeg_sampling"])
    raise ValueError(f"unknown tile format {tiles['format']!r}")


def make_state(seed: int, params: dict, pool) -> list[bytes]:
    n = params["tiles"]["count"]
    if params["grid"]["tiles_per_job"] > n:
        raise ValueError("a job's tiles must be unique: tiles_per_job > count")
    return pool.map("stitchbench.kinds.grid:make_tile",
                    [(seed, params["tiles"], t) for t in range(n)])


def order(seed: int, params: dict, job: int) -> np.ndarray:
    """The tiles of job ``job``, in grid order (row-major)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed % (1 << 64), 2, job]))
    return rng.permutation(params["tiles"]["count"])[: params["grid"]["tiles_per_job"]]


def canvas(params: dict) -> tuple[int, int]:
    """(height, width) of a job's output."""
    tiles, grid = params["tiles"], params["grid"]
    rows = math.ceil(grid["tiles_per_job"] / grid["columns"])
    return rows * tiles["height"], grid["columns"] * tiles["width"]


def jpeg_blocks(height: int, width: int, sampling: str) -> int:
    """8x8 blocks of a baseline JPEG's three components, padded to MCUs."""
    if sampling == "420":
        return 6 * -(-height // 16) * -(-width // 16)
    return 3 * -(-height // 8) * -(-width // 8)


def input_bytes(params: dict) -> int:
    """PNG tiles: the canvas's RGBA8 pixels uploaded. JPEG tiles, decoded
    on the card: their quantized coefficients (2 bytes each, 64 a block)."""
    tiles = params["tiles"]
    if tiles["format"] == "jpeg":
        blocks = jpeg_blocks(tiles["height"], tiles["width"], tiles["jpeg_sampling"])
        return params["grid"]["tiles_per_job"] * blocks * 64 * 2
    h, w = canvas(params)
    return h * w * 4


def job(seed: int, params: dict, state: list[bytes] | None, index: int) -> Job:
    """Job ``index``; with ``state`` None, its spec alone."""
    chosen = order(seed, params, index)
    fmt = params["tiles"]["format"]
    inputs = None if state is None else [
        tag(state[t], fmt, f"stitchbench seed {seed} job {index} tile {t}") for t in chosen]
    columns = params["grid"]["columns"]
    spec = JobSpec(canvas(params),
                   ("stitchbench.reference.layout:canvas_rows",
                    (seed, params["tiles"], columns, chosen)),
                   input_bytes(params))
    return Job({"inputs": inputs, "layout": {"columns": columns}}, spec)
