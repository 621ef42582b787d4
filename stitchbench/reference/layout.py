"""The grid layout: a job's canvas rows rebuilt from its tiles.

Tiles of one size fill a grid row-major, ``columns`` across, with no gaps
(the upstream's grid mode with equal tiles: each column as wide and each
row as tall as its tiles). A PNG tile's pixels are rebuilt from the seed,
which is what its file holds losslessly; a JPEG tile's are what the
reference's reader makes of the file, made again from the seed and kept
for the process.
"""

from __future__ import annotations

import numpy as np

from stitchbench.common.tiles import photo_rows
from stitchbench.reference import jpeg as ref_jpeg
from stitchbench.reference.jpeg_decode import decode

_decoded: dict = {}


def tile_rows(seed: int, tiles: dict, tile: int, a: int, b: int) -> np.ndarray:
    """Rows a:b of tile ``tile`` as the program must read them."""
    if tiles["format"] == "png":
        return photo_rows(seed, tile, tiles["height"], tiles["width"], a, b)
    key = (seed, tile, tuple(sorted(tiles.items())))
    if key not in _decoded:
        rgba = photo_rows(seed, tile, tiles["height"], tiles["width"])
        _decoded[key] = decode(ref_jpeg.encode(rgba, tiles["jpeg_quality"], tiles["jpeg_sampling"]))
    return _decoded[key][a:b]


def canvas_rows(seed: int, tiles: dict, columns: int, order, r0: int, r1: int) -> np.ndarray:
    """Rows ``r0:r1`` of the canvas of tiles ``order``: (r1 - r0, W, 4)."""
    if len(order) % columns:
        raise ValueError("the reference lays out whole grid rows only")
    th, tw = tiles["height"], tiles["width"]
    out = np.empty((r1 - r0, columns * tw, 4), np.uint8)
    for tr in range(r0 // th, (r1 - 1) // th + 1):
        a, b = max(r0, tr * th), min(r1, (tr + 1) * th)
        for c, t in enumerate(order[tr * columns: (tr + 1) * columns]):
            out[a - r0: b - r0, c * tw: (c + 1) * tw] = tile_rows(
                seed, tiles, int(t), a - tr * th, b - tr * th)
    return out
