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
