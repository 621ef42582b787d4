"""The torch port's PNG filter select against the JAX package.

``kernels.filter_select`` on CPU tensors (its plain version) against the
Pallas ``filter_select_pallas(interpret=True)`` and the XLA
``filter_select_trace`` at the shapes of tests/unit/test_pallas_kernels.py;
the host shim (csrc/host_shim.cpp, built with g++) runs the CUDA kernel's
own body against the plain version; ``TorchBackend`` against the host
tier's ``NumpyBackend`` across bands. Everything is integer: the tolerance
is zero.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_stitch_tpu.ops.backend import NumpyBackend
from image_stitch_tpu.ops.device import filter_select_trace
from image_stitch_tpu.ops.pallas_kernels import filter_select_pallas
from image_stitch_tpu.ops.pixel import band_to_bytes
from image_stitch_tpu.ops.png_filter import filter_select_band
from image_stitch_tpu_torch._build import load_host_shim
from image_stitch_tpu_torch.ops import kernels as K
from image_stitch_tpu_torch.ops.device import TorchBackend
from image_stitch_tpu_torch.ops.counters import EncodeCounters

torch.set_num_threads(1)


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data_as(ctypes.c_void_p).value


def port(raw: np.ndarray, prev: np.ndarray | None, bpp: int):
    prev = np.zeros(raw.shape[1], np.uint8) if prev is None else prev
    types, filtered = K.filter_select(torch.from_numpy(raw), torch.from_numpy(prev), bpp)
    return types.numpy(), filtered.numpy()


@pytest.mark.parametrize("carry", [True, False])
@pytest.mark.parametrize("shape", [(16, 512), (13, 260), (64, 1024)])
@pytest.mark.parametrize("bpp", [3, 4, 8])
def test_plain_matches_pallas_and_trace(shape, bpp, carry):
    rng = np.random.default_rng(shape[0] * bpp + carry)
    raw = rng.integers(0, 256, shape, dtype=np.uint8)
    prev = rng.integers(0, 256, shape[1], dtype=np.uint8) if carry else None
    types, filtered = port(raw, prev, bpp)
    p_types, p_filtered, p_last = filter_select_pallas(raw, prev, bpp, interpret=True)
    np.testing.assert_array_equal(types, np.asarray(p_types))
    np.testing.assert_array_equal(filtered, np.asarray(p_filtered))
    np.testing.assert_array_equal(np.asarray(p_last), raw[-1])
    prev_j = jnp.zeros(shape[1], jnp.uint8) if prev is None else jnp.asarray(prev)
    t_choice, t_filtered, _ = filter_select_trace(jnp.asarray(raw), prev_j, bpp)
    np.testing.assert_array_equal(types, np.asarray(t_choice).astype(np.uint8))
    np.testing.assert_array_equal(filtered, np.asarray(t_filtered))


def test_tie_goes_to_the_earlier_filter():
    """tests/unit/test_png_filter.py:93: on all-zero rows every filter
    scores 0 and None (0) must win."""
    types, filtered = port(np.zeros((3, 12), np.uint8), None, 4)
    assert list(types) == [0, 0, 0]
    assert not filtered.any()


def test_png_bytes_matches_band_to_bytes():
    band = np.random.default_rng(1).integers(0, 65536, (3, 5, 4), dtype=np.uint16)
    got = K.png_bytes(torch.from_numpy(band.view(np.uint8)).view(torch.uint16))
    np.testing.assert_array_equal(got.numpy(), band_to_bytes(band))


SHIM_CASES = [((16, 512), 4, np.uint8), ((13, 260), 3, np.uint8), ((9, 7, 4), 4, np.uint8),
              ((6, 11, 4), 8, np.uint16), ((5, 3), 4, np.uint8), ((4, 1, 4), 8, np.uint16)]


@pytest.mark.parametrize("shape,bpp,dtype", SHIM_CASES)
def test_kernel_body_matches_plain(shape, bpp, dtype):
    """csrc/filter.cuh, compiled by g++ into the serial host shim, against
    the plain version: uint8 bytes, uint16 samples read big-endian in place
    (swap), and rows narrower than bpp."""
    shim = load_host_shim()
    rng = np.random.default_rng(len(shape) * 100 + shape[0])
    band = rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype=dtype)
    h = shape[0]
    n = band[0].nbytes
    prev = rng.integers(0, 256, n, dtype=np.uint8)
    filtered = np.zeros((h, n), np.uint8)
    types = np.zeros(h, np.uint8)
    shim.filter_select_host(_ptr(band), _ptr(prev), _ptr(filtered), _ptr(types), h, n, bpp,
                            int(dtype == np.uint16), 0)
    t = torch.from_numpy(band.view(np.uint8))
    if dtype == np.uint16:
        t = t.view(torch.uint16)
    p_types, p_filtered = K.filter_select_plain(t, torch.from_numpy(prev), bpp)
    np.testing.assert_array_equal(types, p_types.numpy())
    np.testing.assert_array_equal(filtered, p_filtered.numpy())
    exp_types, exp_filtered = filter_select_band(band_to_bytes(band.reshape(h, -1, 1)), prev, bpp)
    np.testing.assert_array_equal(types, exp_types)
    np.testing.assert_array_equal(filtered, exp_filtered)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_backend_matches_numpy_backend_across_bands(dtype):
    """Two bands through TorchBackend and NumpyBackend: the second band's
    first row filters against the carry of the first."""
    rng = np.random.default_rng(int(dtype == np.uint16))
    bands = [rng.integers(0, np.iinfo(dtype).max + 1, (h, 13, 4), dtype=dtype) for h in (7, 5)]
    # Smooth rows make Up and Paeth win, so the carry decides row 0's choice.
    bands[1][:] = bands[0][-1]
    counters = EncodeCounters()
    torch_b, numpy_b = TorchBackend("cpu", counters), NumpyBackend()
    t_prev = n_prev = None
    for band in bands:
        pending = torch_b.png_filter_band_async(band, t_prev)
        t_prev = pending.carry
        got = torch_b.png_filter_band_wait(pending)
        want = numpy_b.png_filter_band(band, n_prev)
        n_prev = want[2]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert counters.png_bands == 2
    # A host carry row (NumpyBackend's form) is taken as well.
    got = torch_b.png_filter_band(bands[1], n_prev)
    np.testing.assert_array_equal(got[1], numpy_b.png_filter_band(bands[1], n_prev)[1])


def test_wrapper_checks_inputs_and_counts_only_launches():
    band = torch.zeros((4, 8, 4), dtype=torch.uint8)
    prev = torch.zeros(32, dtype=torch.uint8)
    before = K.filter_select.launches
    K.filter_select(band, prev, 4)
    assert K.filter_select.launches == before  # the CPU path launches nothing
    with pytest.raises(TypeError):
        K.filter_select(band.to(torch.int32), prev, 4)
    with pytest.raises(ValueError):
        K.filter_select(band, prev[:-1], 4)
    with pytest.raises(ValueError):
        K.filter_select(band[:, ::2], prev[:16], 4)
    with pytest.raises(ValueError):
        K.filter_select(band, prev, 0)
    with pytest.raises(TypeError):
        K.filter_select(band, prev.to(torch.int32), 4)


def shim_filter(band: np.ndarray, prev: np.ndarray, bpp: int, words: int):
    """The host shim's filter select over ``band`` (uint8 bytes or uint16
    samples), in the word form (words = 1) or the byte form."""
    shim = load_host_shim()
    h, n = band.shape[0], band[0].nbytes
    band = np.ascontiguousarray(band)
    filtered = np.zeros((h, n), np.uint8)
    types = np.zeros(h, np.uint8)
    shim.filter_select_host(_ptr(band), _ptr(prev), _ptr(filtered), _ptr(types), h, n, bpp,
                            int(band.dtype == np.uint16), words)
    return types, filtered


def plain_filter(band: np.ndarray, prev: np.ndarray, bpp: int):
    t = torch.from_numpy(np.ascontiguousarray(band).view(np.uint8))
    if band.dtype == np.uint16:
        t = t.view(torch.uint16)
    types, filtered = K.filter_select_plain(t, torch.from_numpy(prev), bpp)
    return types.numpy(), filtered.numpy()


def _rows(kind: str, rng, shape, dtype):
    top = np.iinfo(dtype).max
    if kind == "random":
        return rng.integers(0, top + 1, shape, dtype=dtype)
    if kind == "extremes":  # 0 and the maximum: Paeth's widest differences
        return (rng.integers(0, 2, shape) * top).astype(dtype)
    if kind == "0x80":  # residues of 0x80 score 128 under every filter
        return np.full(shape, 0x80 if dtype == np.uint8 else 0x8080, dtype)
    # Smooth ramps with sparse steps: Up, Average and Paeth each win rows.
    base = np.cumsum(rng.integers(0, 3, shape), axis=-1) % (top + 1)
    return (base + rng.integers(0, 2, shape[:1])[(...,) + (None,) * (len(shape) - 1)]).astype(dtype)


# (h, row shape, dtype, bpp): every bpp from 1 to 8; rows with n % 16 of 0,
# 4 and 12, and rows with n % 4 != 0; 16-bit samples, read with the swap.
WORD_CASES = [
    *[(6, (48,), np.uint8, bpp) for bpp in range(1, 9)],
    (7, (16, 4), np.uint8, 4), (7, (17, 4), np.uint8, 4), (7, (19, 4), np.uint8, 4),
    (5, (8, 8), np.uint8, 8), (5, (9, 8), np.uint8, 8), (5, (11, 4), np.uint8, 8),
    (6, (66,), np.uint8, 4), (6, (63,), np.uint8, 8), (4, (2,), np.uint8, 4),
    (6, (8, 4), np.uint16, 8), (6, (9, 4), np.uint16, 8), (5, (11, 4), np.uint16, 8),
    (4, (1, 4), np.uint16, 8), (6, (12, 2), np.uint16, 4),
]


@pytest.mark.parametrize("kind", ["random", "extremes", "0x80", "smooth"])
@pytest.mark.parametrize("h,row,dtype,bpp", WORD_CASES)
def test_word_body_matches_plain(h, row, dtype, bpp, kind):
    """csrc/filter.cuh's word form (the card's word kernel) and byte form
    (its byte kernel), run by the host shim, against the plain version after
    a non-zero carry row. The word form takes bpp 4 and 8 with rows of a
    whole number of words; the wrapper sends every other shape to the byte
    kernel (``filter_variant``)."""
    rng = np.random.default_rng(h * 1000 + row[0] * 10 + bpp)
    band = _rows(kind, rng, (h, *row), dtype)
    n = band[0].nbytes
    prev = _rows(kind, rng, (n,), np.uint8) | np.uint8(1) if kind != "0x80" else \
        np.full(n, 0x80, np.uint8)
    want = plain_filter(band, prev, bpp)
    word = bpp in (4, 8) and n % 4 == 0
    assert (K.filter_variant(n, bpp, 0, 0, 0) != 0) == word
    for words in ((0, 1) if word else (0,)):
        types, filtered = shim_filter(band, prev, bpp, words)
        np.testing.assert_array_equal(types, want[0])
        np.testing.assert_array_equal(filtered, want[1])


def test_filter_variant_dispatch():
    """The wrapper's choice of kernel: the word kernel with 16 B loads only
    where the rows and every pointer are 16 B aligned."""
    names = [K.FILTER_VARIANTS[K.filter_variant(n, bpp, *ptrs)] for n, bpp, ptrs in [
        (32768, 4, (0, 256, 512)), (65536, 8, (0, 256, 512)), (32772, 4, (0, 256, 512)),
        (32776, 8, (0, 256, 512)), (32768, 4, (0, 4, 512)), (32768, 3, (0, 256, 512)),
        (32770, 4, (0, 256, 512)), (32768, 8, (2, 256, 512)),
    ]]
    assert names == ["word4_vec16", "word8_vec16", "word4", "word8", "word4", "bytes",
                     "bytes", "bytes"]


def _lane(w: np.ndarray, k: int) -> np.ndarray:
    return ((w >> np.uint32(8 * k)) & np.uint32(0xFF)).astype(np.int32)


def _word(lanes) -> np.ndarray:
    out = np.zeros(lanes[0].shape, np.uint32)
    for k, v in enumerate(lanes):
        out |= (np.asarray(v, np.uint32) & np.uint32(0xFF)) << np.uint32(8 * k)
    return out


def _shim_words(k, x, a, b, c):
    shim = load_host_shim()
    x, a, b, c = (np.ascontiguousarray(v, np.uint32) for v in (x, a, b, c))
    out = np.zeros_like(x)
    scores = np.zeros_like(x)
    shim.filter_words_host(k, _ptr(x), _ptr(a), _ptr(b), _ptr(c), _ptr(out), _ptr(scores),
                           x.size)
    return out, scores


def test_word_paeth_every_neighbourhood():
    """The byte-lane Paeth (filter.cuh filter_paeth4: nine-bit pc from the
    signs of the two differences) against png-filter.ts's predictor on all
    256^3 (left, up, upleft) triples, with the residue's score."""
    rng = np.random.default_rng(3)
    a_all, b_all = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    for c0 in range(0, 256, 64):
        # One word per (a, b) pair and each four upleft values of the slice.
        c_lanes = [np.full(a_all.shape, c0 + 16 * lane_k, np.int32) for lane_k in range(4)]
        for step in range(16):
            cl = [v + step for v in c_lanes]
            x = rng.integers(0, 256, (4,) + a_all.shape)
            got, scores = _shim_words(4, _word(list(x)), _word([a_all] * 4), _word([b_all] * 4),
                                      _word(cl))
            for k in range(4):
                a, b, c = a_all, b_all, cl[k]
                p = a + b - c
                pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
                want = (x[k] - pred) & 0xFF
                np.testing.assert_array_equal(_lane(got, k), want)
            res = [_lane(got, k) for k in range(4)]
            np.testing.assert_array_equal(
                scores, sum(np.where(r > 127, 256 - r, r) for r in res))


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_word_residues_and_scores(k):
    """None, Sub, Up and Average per lane against the byte formulas, on
    random words and on every byte value in each lane (0x80 included)."""
    rng = np.random.default_rng(k)
    words = rng.integers(0, 1 << 32, (4, 4096), dtype=np.uint64).astype(np.uint32)
    every = _word([np.arange(256)] * 4)
    x, a, b, c = (np.concatenate([w, every, every[::-1]]) for w in words)
    got, scores = _shim_words(k, x, a, b, c)
    for lane_k in range(4):
        xl, al, bl = _lane(x, lane_k), _lane(a, lane_k), _lane(b, lane_k)
        want = [xl, xl - al, xl - bl, xl - ((al + bl) >> 1)][k] & 0xFF
        np.testing.assert_array_equal(_lane(got, lane_k), want)
    res = [_lane(got, lane_k) for lane_k in range(4)]
    np.testing.assert_array_equal(scores, sum(np.where(r > 127, 256 - r, r) for r in res))
