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
                            int(dtype == np.uint16))
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
