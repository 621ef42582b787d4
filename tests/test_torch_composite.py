"""The torch port's positioned compositor against the JAX package.

``ops.composite_device.DeviceCompositor`` and ``kernels.composite_segments``
on the CPU (the plain version) against the JAX ``DeviceCompositor``, its
``_composite_run_trace`` scan and the host float64 oracle, after
tests/unit/test_composite_device.py:34-75; the host shim runs the CUDA
kernel's own per-pixel body against the plain version. Everything is
integer: the tolerance is zero.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_stitch_tpu.ops import composite_device as J
from image_stitch_tpu.ops.pixel import composite_band
from image_stitch_tpu_torch._build import load_host_shim
from image_stitch_tpu_torch.ops import composite_device as C
from image_stitch_tpu_torch.ops import kernels as K
from image_stitch_tpu_torch.ops.composite_device import DeviceCompositor

torch.set_num_threads(1)


def oracle(canvas, segments):
    ref = canvas.copy()
    for rows, y0, x0 in segments:
        composite_band(ref[y0 : y0 + rows.shape[0]], rows, start_x=x0)
    return ref


def make_segments(seed, n=4, smooth_alpha=True):
    """test_composite_device.py's segments: random colours, and alpha a
    30-230 ramp (smooth) or random."""
    rng = np.random.default_rng(seed)
    segs = []
    for _ in range(n):
        h, w = int(rng.integers(10, 40)), int(rng.integers(10, 50))
        s = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        if smooth_alpha:
            s[:, :, 3] = np.linspace(30, 230, w).astype(np.uint8)[None, :]
        segs.append((s, int(rng.integers(0, 20)), int(rng.integers(0, 40))))
    return segs


def pack(segments):
    """(metas, srcs) for composite_segments: segments packed unpadded."""
    metas, parts, off = [], [], 0
    for rows, y0, x0 in segments:
        h, w = rows.shape[:2]
        metas.append((y0, x0, h, w, off, w * 4))
        parts.append(np.ascontiguousarray(rows).reshape(-1))
        off += rows.size
    return np.array(metas, np.int64).reshape(-1, K.META_COLS), np.concatenate(parts)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_matches_jax_compositor_and_oracle(seed):
    canvas = np.zeros((64, 96, 4), np.uint8)
    segs = make_segments(seed)
    dc = DeviceCompositor("cpu")
    out = dc.composite_band(canvas.copy(), segs)
    assert out is not None and dc.bands_on_device == 1
    np.testing.assert_array_equal(out.numpy(), oracle(canvas, segs))
    jax_out = J.DeviceCompositor().composite_band(canvas.copy(), segs)
    np.testing.assert_array_equal(out.numpy(), jax_out)


@pytest.mark.parametrize("seed", [4, 8])
def test_random_alpha_ties_match_jax_scan(seed):
    """Random alpha over a transparent canvas ties now and then (seed 4: no
    tie, seed 8: two): the plain version's band and tie count against
    _composite_run_trace, one segment per scan step."""
    canvas = np.zeros((64, 96, 4), np.uint8)
    segs = make_segments(seed, n=8, smooth_alpha=False)
    metas, srcs = pack(segs)
    band, ties = K.composite_segments(torch.from_numpy(metas), torch.from_numpy(srcs),
                                      (0, 0, 0, 0), 64, 96)
    hmax = max(r.shape[0] for r, _, _ in segs)
    wmax = max(r.shape[1] for r, _, _ in segs)
    padded = np.zeros((len(segs), hmax, wmax, 4), np.uint8)
    for i, (rows, _, _) in enumerate(segs):
        padded[i, : rows.shape[0], : rows.shape[1]] = rows
    j_band, j_ties = J._composite_run_trace(jnp.asarray(canvas), jnp.asarray(padded),
                                            jnp.asarray(metas[:, :4].astype(np.int32)))
    np.testing.assert_array_equal(band.numpy(), np.asarray(j_band))
    assert int(ties) == int(j_ties) == {4: 0, 8: 2}[seed]


def test_opaque_and_transparent_fast_paths():
    canvas = np.full((16, 32, 4), (9, 9, 9, 255), np.uint8)
    segs = [(np.full((8, 8, 4), (200, 10, 30, 255), np.uint8), 0, 0),
            (np.zeros((8, 8, 4), np.uint8), 4, 4)]
    out = DeviceCompositor("cpu").composite_band(canvas.copy(), segs)
    np.testing.assert_array_equal(out.numpy(), oracle(canvas, segs))


def tie_segments():
    """(As=2, Ad=6, s=5, d=174): an exact round-half tie where float64
    rounds down (131) and the integer rational up (132)."""
    base = np.zeros((8, 8, 4), np.uint8)
    base[:, :, :3] = 174
    base[:, :, 3] = 6
    top = np.zeros((8, 8, 4), np.uint8)
    top[:, :, :3] = 5
    top[:, :, 3] = 2
    return [(base, 0, 0), (top, 0, 0)]


def test_exact_rational_tie_falls_back():
    canvas = np.zeros((8, 8, 4), np.uint8)
    dc = DeviceCompositor("cpu")
    assert dc.composite_band(canvas.copy(), tie_segments()) is None
    assert dc.bands_fallback == 1 and dc.bands_on_device == 0
    assert oracle(canvas, tie_segments())[0, 0, 0] == 131
    metas, srcs = pack(tie_segments())
    band, ties = K.composite_segments(torch.from_numpy(metas), torch.from_numpy(srcs),
                                      (0, 0, 0, 0), 8, 8)
    assert int(ties) == 64 and int(band[0, 0, 0]) == 132


def test_16bit_band_and_no_segments_rejected():
    dc = DeviceCompositor("cpu")
    canvas = np.zeros((8, 8, 4), np.uint16)
    assert dc.composite_band(canvas, [(np.zeros((4, 4, 4), np.uint16), 0, 0)]) is None
    assert dc.composite_band(np.zeros((8, 8, 4), np.uint8), []) is None
    assert dc.bands_on_device == dc.bands_fallback == 0


def test_drawn_canvas_takes_the_host_path():
    """Only a uniform background fill is the compositor's contract."""
    canvas = np.zeros((16, 16, 4), np.uint8)
    canvas[-1, -1] = 7
    assert DeviceCompositor("cpu").composite_band(canvas, make_segments(1, n=1)) is None


def test_segments_past_the_band_are_clipped():
    canvas = np.zeros((20, 30, 4), np.uint8)
    segs = make_segments(6, n=3)
    segs.append((np.full((12, 40, 4), 200, np.uint8), 15, 10))
    out = DeviceCompositor("cpu").composite_band(canvas.copy(), segs)
    clipped = [(rows[: 20 - y0, : 30 - x0], y0, x0) for rows, y0, x0 in segs]
    np.testing.assert_array_equal(out.numpy(), oracle(canvas, clipped))


def test_band_over_2gib_of_segments_stays_on_the_kernel(monkeypatch):
    """Four 1 GiB segments (broadcast views, which hold no memory) put byte
    offsets past 2^31: the metas carry them in int64 and the band goes to
    the kernel wrapper, never to the host compositor."""
    seen = {"band": torch.zeros(4, dtype=torch.uint8)}

    def fake_kernel(metas, srcs, bg, h, w):
        seen["metas"] = metas.numpy().copy()
        return seen["band"], torch.zeros((), dtype=torch.int32)

    monkeypatch.setattr(C, "composite_segments", fake_kernel)
    monkeypatch.setattr(C, "_pack", lambda parts: np.zeros(16, np.uint8))
    width = 1 << 20
    canvas = np.broadcast_to(np.array([1, 2, 3, 255], np.uint8), (256, width, 4))
    seg = np.broadcast_to(np.array([9, 9, 9, 128], np.uint8), (256, width, 4))
    dc = DeviceCompositor("cpu")
    out = dc.composite_band(canvas, [(seg, 0, 0)] * 4)
    assert out is seen["band"]
    assert dc.bands_on_device == 1 and dc.bands_fallback == 0
    metas = seen["metas"]
    assert metas.dtype == np.int64
    np.testing.assert_array_equal(metas[:, 4], [0, 1 << 30, 2 << 30, 3 << 30])


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data_as(ctypes.c_void_p).value


@pytest.mark.parametrize("case", ["smooth", "random-8", "random-9", "tie"])
def test_kernel_body_matches_plain(case):
    """csrc/composite.cuh, compiled by g++ into the serial host shim,
    against the plain version, tie counts included."""
    shim = load_host_shim()
    if case == "tie":
        segs, bg = tie_segments(), np.zeros(4, np.uint8)
    else:
        seed = int(case.split("-")[1]) if "-" in case else 7
        segs = make_segments(seed, n=6, smooth_alpha=case == "smooth")
        bg = np.array([10, 20, 30, 40], np.uint8)
    metas, srcs = pack(segs)
    out = np.zeros((64, 96, 4), np.uint8)
    ties = shim.composite_segments_host(_ptr(metas), len(metas), _ptr(srcs), _ptr(bg),
                                        _ptr(out), 64, 96)
    band, p_ties = K.composite_segments(torch.from_numpy(metas), torch.from_numpy(srcs),
                                        bg.tolist(), 64, 96)
    np.testing.assert_array_equal(out, band.numpy())
    assert ties == int(p_ties)
    if case == "tie":
        assert ties == 64


def test_wrapper_checks_inputs_and_counts_only_launches():
    metas, srcs = (torch.from_numpy(a) for a in pack(make_segments(1, n=2)))
    before = K.composite_segments.launches
    K.composite_segments(metas, srcs, (0, 0, 0, 0), 64, 96)
    assert K.composite_segments.launches == before  # the CPU path launches nothing
    with pytest.raises(TypeError):
        K.composite_segments(metas.to(torch.int32), srcs, (0, 0, 0, 0), 64, 96)
    with pytest.raises(ValueError):
        K.composite_segments(metas[:, :4].contiguous(), srcs, (0, 0, 0, 0), 64, 96)
    with pytest.raises(ValueError):
        K.composite_segments(metas, srcs, (0, 0, 256, 0), 64, 96)
    with pytest.raises(ValueError):
        K.composite_segments(metas, srcs, (0, 0, 0, 0), -1, 96)


def shim_composite(metas, srcs, bg, h, w):
    shim = load_host_shim()
    metas = np.ascontiguousarray(metas, np.int64).reshape(-1, K.META_COLS)
    srcs = np.ascontiguousarray(srcs) if srcs.size else np.zeros(4, np.uint8)
    bg = np.asarray(bg, np.uint8)
    out = np.zeros((h, w, 4), np.uint8)
    ties = shim.composite_segments_host(_ptr(metas), len(metas), _ptr(srcs), _ptr(bg), _ptr(out),
                                        h, w)
    return out, ties


def placed(rng, specs, alpha="ramp"):
    """Segments at the given (y0, x0, h, w), random colours, alpha a 30-230
    ramp, random, or opaque."""
    segs = []
    for y0, x0, h, w in specs:
        s = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        if alpha == "ramp" and w:
            s[:, :, 3] = np.linspace(30, 230, w).astype(np.uint8)[None, :]
        elif alpha == "opaque":
            s[:, :, 3] = 255
        segs.append((s, y0, x0))
    return segs


def culling_case(name):
    """(segments, band height, band width) of one tile-culling case; tiles
    are 16 rows x 128 columns, culled 256 segments at a time."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "straddle":  # across tile rows and columns, and the corner
        return placed(rng, [(10, 120, 12, 20), (0, 100, 40, 200), (15, 127, 2, 2),
                            (30, 250, 10, 6), (16, 128, 16, 128)]), 40, 300
    if name == "thin":  # one row, one column, one pixel, on tile edges
        return placed(rng, [(15, 0, 1, 300), (0, 127, 48, 1), (16, 128, 1, 1), (47, 299, 1, 1),
                            (5, 0, 1, 1)]), 48, 300
    if name == "ragged":  # band sizes off the tile and the 16 B line
        return placed(rng, [(0, 0, 37, 333), (20, 300, 17, 33), (3, 7, 30, 250)],
                      "random"), 37, 333
    if name == "many":  # 600 segments: three culling chunks in z order
        specs = [(int(rng.integers(0, 40)), int(rng.integers(0, 250)), 0, 0) for _ in range(600)]
        specs = [(y, x, int(rng.integers(1, 41 - y)), int(rng.integers(1, 251 - x)))
                 for y, x, _, _ in specs]
        return placed(rng, specs, "random"), 41, 251
    if name == "z-order":  # opaque and partial segments stacked: order decides
        segs = placed(rng, [(0, 0, 20, 150), (5, 60, 20, 150), (2, 30, 10, 200)], "opaque")
        segs += placed(rng, [(4, 50, 12, 140), (0, 0, 24, 200)])
        segs += placed(rng, [(8, 100, 6, 40)], "opaque")
        return segs, 26, 240
    if name == "zero-area":  # no rows or no columns: touch nothing
        return placed(rng, [(3, 4, 0, 10), (3, 4, 10, 0), (0, 0, 0, 0), (2, 2, 5, 5),
                            (6, 126, 0, 5)]), 16, 140
    raise ValueError(name)


@pytest.mark.parametrize("bg", [(0, 0, 0, 0), (12, 200, 7, 255), (90, 80, 70, 128)])
@pytest.mark.parametrize("name", ["straddle", "thin", "ragged", "many", "z-order", "zero-area"])
def test_tile_walk_matches_plain(name, bg):
    """csrc/composite.cuh's tile culling and run blend, walked by the host
    shim tile by tile and chunk by chunk as the card's blocks walk them,
    against the plain version: band and tie count."""
    segs, h, w = culling_case(name)
    metas, srcs = pack(segs)
    out, ties = shim_composite(metas, srcs, bg, h, w)
    band, p_ties = K.composite_segments(torch.from_numpy(metas), torch.from_numpy(srcs), bg, h, w)
    np.testing.assert_array_equal(out, band.numpy())
    assert ties == int(p_ties)
    if name == "many":
        assert len(segs) > 2 * 256


def test_z_order_decides():
    """Swapping two overlapping segments changes the band: the culled list
    keeps z order."""
    segs, h, w = culling_case("z-order")
    a, _ = shim_composite(*pack(segs), (0, 0, 0, 0), h, w)
    b, _ = shim_composite(*pack(segs[::-1]), (0, 0, 0, 0), h, w)
    assert not np.array_equal(a, b)


def _px(r, g, b, a):
    return (np.asarray(r, np.uint32) | np.asarray(g, np.uint32) << 8
            | np.asarray(b, np.uint32) << 16 | np.asarray(a, np.uint32) << 24)


def test_divmod_is_exact_next_to_every_multiple():
    """composite_divmod (a 32-bit reciprocal of den a little below 2^32 /
    den, a high multiply, then one step up) against integer divmod for
    every den of the "over" (255 .. 65,025) at num = k den - 1, k den and
    k den + 1, where the estimate of the quotient falls one short or not,
    and at random num up to 255 den."""
    rng = np.random.default_rng(5)
    den = np.arange(255, 255 * 255 + 1, dtype=np.int32)
    nums = [np.minimum(np.maximum(k * den + delta, 0), 255 * den)
            for k in range(0, 256, 15) for delta in (-1, 0, 1)]
    nums += [(rng.random(den.shape) * (255 * den + 1)).astype(np.int32) for _ in range(4)]
    shim = load_host_shim()
    for num in nums:
        num = np.ascontiguousarray(num, np.int32)
        q, r = np.zeros_like(num), np.zeros_like(num)
        shim.composite_divmod_host(_ptr(num), _ptr(den), _ptr(q), _ptr(r), num.size)
        np.testing.assert_array_equal(q, num // den)
        np.testing.assert_array_equal(r, num % den)


def test_one_division_over_every_alpha_pair():
    """alpha_over_px (one division per channel from a float reciprocal and
    a +-1 correction) against the two-division formula of
    _alpha_over_window_u8 over every (As, Ad) pair, each with 24 colour
    pixels: 72 (s, d) channel pairs, extremes included, and s = d and
    s = d +- 1, where num is a multiple of den or next to one and the float
    estimate of the quotient is one off in either direction. Ties as well."""
    rng = np.random.default_rng(11)
    a_s, a_d = (v.reshape(-1) for v in np.meshgrid(np.arange(256), np.arange(256), indexing="ij"))
    fixed = np.array([[0, 0], [255, 255], [0, 255], [255, 0], [128, 127], [1, 254]])
    for rep in range(24):
        if rep < 2:
            pairs = [fixed[(3 * rep + c) % len(fixed)] for c in range(3)]
            s_rgb = [np.full(a_s.shape, p[0]) for p in pairs]
            d_rgb = [np.full(a_s.shape, p[1]) for p in pairs]
        else:
            s_rgb = [rng.integers(0, 256, a_s.shape) for _ in range(3)]
            step = (rep % 4) - 1  # -1, 0, 1: d next to or equal to s; 2: random
            d_rgb = [np.clip(sc + step, 0, 255) if step < 2 else rng.integers(0, 256, a_s.shape)
                     for sc in s_rgb]
        s = _px(*s_rgb, a_s)
        d = _px(*d_rgb, a_d)
        got = d.copy()
        ties = load_host_shim().alpha_over_host(_ptr(s), _ptr(got), s.size)
        wd = a_d * (255 - a_s)
        den = 255 * a_s + wd
        blend = (a_s > 0) & (a_s < 255)
        den_safe = np.maximum(den, 1)
        want_rgb, tie = [], np.zeros(a_s.shape, bool)
        for sc, dc in zip(s_rgb, d_rgb):
            num = sc * 255 * a_s + dc * wd
            q = (2 * num + den_safe) // (2 * den_safe)
            tie |= blend & ((2 * num) % (2 * den_safe) == den_safe)
            want_rgb.append(np.where(a_s == 255, sc, np.where(blend, q, dc)))
        new_a = np.where(a_s == 255, 255, np.where(blend, (2 * den + 255) // 510, a_d))
        np.testing.assert_array_equal(got, _px(*want_rgb, new_a))
        assert ties == int(tie.sum())
