"""Photo-like RGBA tiles made from a seed, any rows of a tile on demand.

The content is ``chip_smoke.py``'s ``photo_tile`` rewritten so that a row
range can be made alone: smooth colour fields (a product of a sine across
and a cosine down), hard edges (the sign of a sine along the diagonal) and
sensor-like noise, opaque. The noise of each row comes from its own
generator, seeded by (seed, tile, row), so the reference can rebuild any
rows of a canvas without keeping or decoding the inputs.
"""

from __future__ import annotations

import numpy as np


def _seeds(seed: int, *keys: int) -> np.random.SeedSequence:
    return np.random.SeedSequence([seed % (1 << 64), *keys])


def tile_params(seed: int, tile: int) -> np.ndarray:
    """Per-channel (f1, f2, f3, p1, p2) of a tile's colour fields."""
    rng = np.random.default_rng(_seeds(seed, 0, tile))
    freq = rng.uniform(1.0, 9.0, (3, 3))
    phase = rng.uniform(0.0, 2 * np.pi, (3, 2))
    return np.concatenate([freq, phase], axis=1)


def photo_rows(seed: int, tile: int, height: int, width: int,
               r0: int = 0, r1: int | None = None) -> np.ndarray:
    """Rows ``r0:r1`` of tile ``tile`` (``height`` x ``width``): (r1 - r0,
    width, 4) uint8."""
    r1 = height if r1 is None else r1
    params = tile_params(seed, tile)
    y = (np.arange(r0, r1, dtype=np.float32) / height)[:, None]
    x = (np.arange(width, dtype=np.float32) / width)[None, :]
    noise = np.empty((r1 - r0, width, 3), np.float32)
    for i, r in enumerate(range(r0, r1)):
        noise[i] = np.random.default_rng(_seeds(seed, 1, tile, r)).standard_normal(
            (width, 3), dtype=np.float32)
    out = np.empty((r1 - r0, width, 4), np.uint8)
    for c in range(3):
        f1, f2, f3, p1, p2 = params[c].astype(np.float32)
        two_pi = np.float32(2 * np.pi)
        field = np.float32(60) * np.sin(two_pi * f1 * x + p1) * np.cos(two_pi * f2 * y + p2)
        field = field + np.float32(35) * np.sign(np.sin(two_pi * f3 * (x + y)))
        field += np.float32(110) + np.float32(3) * noise[..., c]
        out[..., c] = np.clip(field, 0, 255).astype(np.uint8)
    out[..., 3] = 255
    return out
