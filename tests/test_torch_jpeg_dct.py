"""The torch port's quantize stage against the JAX package's.

Same seeded inputs through ``image_stitch_tpu.ops.device.jpeg_quantize_trace``
/ ``_420`` (JAX on the CPU) and ``image_stitch_tpu_torch.ops.device``
(plain torch on the CPU). Everything is integer: the tolerance is zero.
"""

import jax
import numpy as np
import pytest
import torch

from image_stitch_tpu.codecs.jpeg.tables import quality_scaled_tables
from image_stitch_tpu.ops.device import jpeg_quantize_420_trace, jpeg_quantize_trace
from image_stitch_tpu.ops.jpeg_dct import ycbcr_int as ycbcr_int_ref
from image_stitch_tpu_torch.ops.device import jpeg_quantize, jpeg_quantize_420
from image_stitch_tpu_torch.ops.jpeg_dct import ycbcr_int

torch.set_num_threads(1)

# One compiled program per reference call (eager dispatch compiles op by op).
quantize_ref = jax.jit(jpeg_quantize_trace)
quantize_420_ref = jax.jit(jpeg_quantize_420_trace)


def make_band(h: int, w: int, seed: int) -> np.ndarray:
    """Random RGBA with a saturated-blue patch (Cb = 256), pure red, white
    and black patches, and a smooth gradient."""
    rng = np.random.default_rng(seed)
    band = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    band[:8, :8] = (0, 0, 255, 255)
    band[:8, 8:16] = (255, 0, 0, 255)
    band[8:16, :8] = 255
    band[8:16, 8:16] = 0
    band[-8:, :, 0] = np.linspace(0, 255, w).astype(np.uint8)
    return band


def test_ycbcr_saturated_blue_reaches_256():
    band = np.zeros((1, 2, 4), np.uint8)
    band[0, 0] = (0, 0, 255, 255)
    band[0, 1] = (255, 0, 0, 255)
    y, cb, cr = ycbcr_int(torch.from_numpy(band))
    ry, rcb, rcr = ycbcr_int_ref(band, np)
    assert int(cb[0, 0]) == 256 and int(cr[0, 1]) == 256
    for got, ref in ((y, ry), (cb, rcb), (cr, rcr)):
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("quality", [1, 50, 85, 100])
def test_quantize_444_matches_jax(quality):
    band = make_band(24, 48, seed=quality)
    lq, cq = quality_scaled_tables(quality)
    ref = quantize_ref(band, lq, cq)
    got = jpeg_quantize(torch.from_numpy(band), torch.from_numpy(lq), torch.from_numpy(cq))
    for g, r in zip(got, ref):
        assert g.dtype == torch.int16 and g.shape == r.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("quality", [1, 50, 85, 100])
def test_quantize_420_matches_jax(quality):
    band = make_band(32, 48, seed=100 + quality)
    lq, cq = quality_scaled_tables(quality)
    ref = quantize_420_ref(band, lq, cq)
    got = jpeg_quantize_420(torch.from_numpy(band), torch.from_numpy(lq), torch.from_numpy(cq))
    for g, r in zip(got, ref):
        assert g.dtype == torch.int16 and g.shape == r.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_quantize_three_channel_band_matches_four():
    """The encoder uploads bands without alpha; the blocks do not change."""
    band = make_band(16, 32, seed=7)
    lq, cq = (torch.from_numpy(q) for q in quality_scaled_tables(85))
    four = jpeg_quantize(torch.from_numpy(band), lq, cq)
    three = jpeg_quantize(torch.from_numpy(np.ascontiguousarray(band[..., :3])), lq, cq)
    for a, b in zip(four, three):
        assert torch.equal(a, b)
