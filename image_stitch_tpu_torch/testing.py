"""Synthetic inputs for checking kernels against their plain versions, made
from a numpy seed: for the batched decode kernels
(``ops.kernels.idct_dequant_batch``, ``ycc_rgba_batch``), bands of several
JPEG tiles of every kind, with their tables, their buffers and what each
tile is; for the fused grid step (``ops.kernels.grid_dual``), tile stacks
whose rows pick every PNG filter. The CPU tests, the ``cuda`` tests and
``chip_smoke.py`` hold the kernels to the same cases.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .codecs.jpeg.device_decoder import _band_window
from .codecs.jpeg.tables import ZIGZAG
from .ops import kernels as K

SAMPLINGS = {"444": (1, 1), "422": (2, 1), "420": (2, 2), "411": (4, 1), "440": (1, 2)}


@dataclass
class Tile:
    """One tile of a band: its sampling ("444", "422", "420", "411", "440";
    ``gray`` keeps the first component only), its size, the image rows
    [y0, y1) the band takes, per component the zigzag prefix k, the
    natural-order quantizer table and the coefficients' amplitude."""

    sampling: str
    width: int
    height: int
    y0: int
    y1: int
    ks: tuple[int, ...] = (64, 64, 64)
    quants: tuple[np.ndarray, ...] = ()
    amplitude: int = 1 << 15
    gray: bool = False


@dataclass
class Band:
    """A band's buffers and tables as the batched wrappers take them, and
    per tile what the single-window wrappers take (``singles``: x0, width,
    per component (zz (n, k), natural-order q, bx, geom))."""

    h: int
    width: int
    coefs: np.ndarray
    qtabs: np.ndarray
    windows: list
    tiles: list
    plane_bytes: int
    singles: list = field(default_factory=list)


def quantizer(rng, high: int) -> np.ndarray:
    """A natural-order (64,) int32 table with values in [1, high]."""
    return rng.integers(1, high + 1, 64).astype(np.int32)


def make_band(rng, tiles: list[Tile], x0s: list[int], width: int) -> Band:
    """The band of ``tiles`` at columns ``x0s`` of a band ``width`` wide:
    random coefficients within each tile's amplitude (the extremes
    +-amplitude - or -32768 for the full range - put into every window),
    every distinct quantizer table once."""
    h = tiles[0].y1 - tiles[0].y0
    qtab_of: dict[bytes, int] = {}
    qtabs, windows, rows, singles, parts = [], [], [], [], []
    coef_at = plane_at = 0
    for tile, x0 in zip(tiles, x0s):
        assert tile.y1 - tile.y0 == h
        hmax, vmax = SAMPLINGS[tile.sampling]
        comps = [(hmax, vmax)] if tile.gray else [(hmax, vmax), (1, 1), (1, 1)]
        comp_rows, comp_singles = [], []
        for c, (hs, vs) in enumerate(comps):
            comp_w, comp_h = -(-tile.width * hs // hmax), -(-tile.height * vs // vmax)
            by, bx = -(-comp_h // (8 * vs)) * vs, -(-comp_w // (8 * hs)) * hs
            h_exp, v_exp = hmax // hs, vmax // vs
            fancy_v = v_exp == 2 and h_exp == 2 and comp_w > 2
            wa, wb, r0 = _band_window(tile.y0, tile.y1, comp_h, v_exp, fancy_v)
            bb, be = wa // 8, min(by, -(-wb // 8))
            n, k, amp = (be - bb) * bx, tile.ks[c], tile.amplitude
            zz = rng.integers(-amp, amp, (n, k)).astype(np.int16)
            zz[0, 0], zz[-1, k - 1] = -amp, amp - 1
            q = tile.quants[c] if tile.quants else quantizer(rng, 255)
            q_zz = np.ascontiguousarray(q[np.asarray(ZIGZAG)])
            key = q_zz.tobytes()
            if key not in qtab_of:
                qtab_of[key] = len(qtabs)
                qtabs.append(q_zz)
            narrow = (int(np.abs(zz.astype(np.int64)).max()) * int(q.max())
                      <= K.IDCT_INT32_MAX_DEQ)
            windows.append((coef_at, n, k, qtab_of[key], bx, plane_at, narrow))
            geom = (h_exp, v_exp, r0, wa - bb * 8, wb - bb * 8, comp_w)
            comp_rows.append((plane_at, bx * 8, h_exp, v_exp, r0, geom[3], geom[4] - geom[3],
                              comp_w))
            comp_singles.append((zz, q, bx, geom))
            parts.append(zz.reshape(-1))
            coef_at += n * k
            plane_at += n * 64
        rows.append((x0, tile.width, comp_rows))
        singles.append((x0, tile.width, comp_singles))
    return Band(h, width, np.concatenate(parts), np.stack(qtabs), windows, rows, plane_at,
                singles)


def mixed_band(seed: int, width_off_4: bool = False) -> Band:
    """Tiles of every kind side by side in one band of 16 rows: 4:4:4, h2v1,
    h2v2 and gray; K 8, 24 and 64; comp_w of 2 and 3; bands at an image's
    top edge, bottom edge and inside it; x0 % 4 of 0, 1, 2 and 3 and widths
    off 4; full-range coefficients under 16-bit quantizers (the 64-bit column
    pass) beside small ones under 8-bit tables (the 32-bit one)."""
    rng = np.random.default_rng(seed)
    big = (quantizer(rng, 65535),) * 3
    small = (quantizer(rng, 16), quantizer(rng, 24), quantizer(rng, 24))
    tiles = [
        Tile("420", 45, 67, 0, 16, ks=(24, 8, 8), quants=small, amplitude=1024),   # top edge
        Tile("444", 37, 40, 8, 24, ks=(64, 24, 24), quants=big),
        Tile("422", 30, 40, 24, 40, ks=(64, 64, 64), amplitude=300),               # bottom edge
        Tile("420", 33, 21, 4, 20, gray=True, ks=(8,), quants=small[:1], amplitude=2000),
        Tile("420", 4, 16, 0, 16, quants=small, amplitude=1024),                   # comp_w 2
        Tile("420", 6, 17, 1, 17, quants=big),                                     # comp_w 3
        Tile("420", 64, 51, 35, 51, ks=(24, 8, 8), quants=small, amplitude=1024),  # bottom edge
        Tile("411", 30, 16, 0, 16, ks=(8, 8, 8)),
        Tile("440", 28, 21, 5, 21, ks=(24, 24, 24), quants=small, amplitude=500),
    ]
    x0s, at = [], 0
    for i, tile in enumerate(tiles):
        at += (i - at) % 4  # a gap, so that x0 % 4 takes 0, 1, 2, 3 in turn
        x0s.append(at)
        at += tile.width
    assert {x % 4 for x in x0s} == {0, 1, 2, 3}
    width = at + (4 - at % 4) % 4 + (3 if width_off_4 else 0)
    return make_band(rng, tiles, x0s, width)


def grid_tiles(shape: tuple[int, int, int, int], seed: int) -> np.ndarray:
    """A (gy, gx, th, tw, 4) uint8 tile stack: each tile random bytes, a
    ramp across (Sub wins), a ramp down (Up wins), a diagonal ramp with
    noise, pure blue (Cb = 256; flat, so every filter but None scores 0
    and ties) or random bytes over rows of zeros, so that a row's filter
    depends on every tile it crosses."""
    gy, gx, th, tw = shape
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(th), np.arange(tw), indexing="ij")
    tiles = np.empty((gy, gx, th, tw, 4), np.uint8)
    for i in range(gy):
        for j in range(gx):
            kind = int(rng.integers(0, 6))
            step, base = rng.integers(1, 9, 4), rng.integers(0, 256, 4)
            if kind == 0:
                t = rng.integers(0, 256, (th, tw, 4))
            elif kind == 1:
                t = xx[..., None] * step + base
            elif kind == 2:
                t = yy[..., None] * step + base
            elif kind == 3:
                t = (xx + yy)[..., None] * step + rng.integers(0, 3, (th, tw, 4))
            elif kind == 4:
                t = np.broadcast_to(np.array([0, 0, 255, 255]), (th, tw, 4))
            else:
                t = rng.integers(0, 256, (th, tw, 4)) * (yy % 3 == 0)[..., None]
            tiles[i, j] = np.asarray(t) % 256
    return tiles
