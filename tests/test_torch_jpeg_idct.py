"""The port's JPEG decode pixel math against the JAX package's.

``image_stitch_tpu_torch.ops.jpeg_idct_device`` (plain torch, the CPU path
of the kernels ``idct_dequant`` and ``ycc_rgba``) and
``image_stitch_tpu.ops.jpeg_idct_device`` (JAX on the CPU) get the same
seeded inputs; their outputs must be equal, byte for byte, and equal to
the int64 host oracle ``image_stitch_tpu.codecs.jpeg.libjpeg_exact``. The
port's int64 IDCT is exact past the JAX file's M_SAFE bound too: at
|coef * q| up to 2^15 * 65535 it still equals the oracle.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from image_stitch_tpu.codecs.jpeg import libjpeg_exact as oracle
from image_stitch_tpu.codecs.jpeg.owned_decoder import decode_baseline_jpeg, decode_coefficients
from image_stitch_tpu.ops import jpeg_idct_device as J
from image_stitch_tpu_torch.ops import jpeg_idct_device as D

torch.set_num_threads(1)


def port_idct(coefq: np.ndarray) -> np.ndarray:
    return D.range_limit(D.idct_islow(torch.from_numpy(coefq))).numpy()


def test_idct_random_legal_range_matches_jax_and_oracle():
    rng = np.random.default_rng(1)
    coefq = (rng.integers(-2047, 2048, (256, 8, 8))
             * rng.integers(1, 256, (256, 1, 1))).astype(np.int32)
    want = oracle.idct_islow_blocks(coefq.astype(np.int64))
    np.testing.assert_array_equal(np.asarray(J.idct_islow_exact(jnp.asarray(coefq), jnp)), want)
    np.testing.assert_array_equal(port_idct(coefq), want)


def test_idct_at_and_past_m_safe():
    """Blocks at +-M_SAFE (the JAX form's bound, where both must agree) and
    at +-2^15 * 65535 (past it: the port only, against the oracle)."""
    for m, with_jax in ((J.M_SAFE, True), ((1 << 15) * 65535, False)):
        blocks = [np.full((8, 8), m), np.full((8, 8), -m),
                  np.fromfunction(lambda r, c: ((r + c) % 2 * 2 - 1) * m, (8, 8))]
        for r in range(8):
            for c in range(8):
                b = np.zeros((8, 8), np.int64)
                b[r, c] = m
                blocks += [b, -b]
        blocks.append(np.random.default_rng(2).integers(-m, m + 1, (8, 8)))
        coefq = np.stack(blocks).astype(np.int64)
        want = oracle.idct_islow_blocks(coefq)
        np.testing.assert_array_equal(port_idct(coefq), want)
        if with_jax:
            got = J.idct_islow_exact(jnp.asarray(coefq.astype(np.int32)), jnp)
            np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("k", [1, 5, 32, 64])
def test_dezigzag_matches_jax(k):
    zz = np.random.default_rng(13).integers(-2047, 2048, (37, k)).astype(np.int16)
    want = J.dezigzag_pad(zz.astype(np.int32), k, np)
    np.testing.assert_array_equal(D.dezigzag_pad(torch.from_numpy(zz), k).numpy(), want)


@pytest.mark.parametrize("k", [8, 24, 64])
def test_decode_plane_matches_jax_trace(k):
    """Dezigzag, dequantize, IDCT, range limit and block assembly of one
    plane, against ``decode_plane_trace`` on int16 coefficients and a
    baseline table."""
    rng = np.random.default_rng(k)
    by, bx = 3, 5
    zz = rng.integers(-300, 301, (by * bx, k)).astype(np.int16)
    q = rng.integers(1, 256, 64).astype(np.int32)
    want = J.decode_plane_trace(jnp.asarray(zz), jnp.asarray(q), by, bx, k, jnp)
    got = D.decode_plane(torch.from_numpy(zz), torch.from_numpy(q), bx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_upsample_ports_match_jax_and_oracle():
    rng = np.random.default_rng(4)
    for h, w in [(8, 8), (16, 24), (3, 5), (1, 4), (7, 3), (5, 2), (4, 1)]:
        plane = rng.integers(0, 256, (h, w), dtype=np.uint8)
        for h_exp, v_exp in [(1, 1), (2, 1), (2, 2), (1, 2), (4, 2)]:
            want = oracle.upsample_plane(plane, h_exp, v_exp)
            jax_out = J.upsample_plane_x(jnp.asarray(plane), h_exp, v_exp, jnp)
            np.testing.assert_array_equal(np.asarray(jax_out).astype(np.uint8), want)
            got = D.upsample_plane_x(torch.from_numpy(plane), h_exp, v_exp)
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{h}x{w} x{h_exp}x{v_exp}")


def test_colour_exhaustive_axes_match_jax_and_oracle():
    rng = np.random.default_rng(5)
    sweep = np.arange(256, dtype=np.uint8)
    mid = np.full(256, 128, np.uint8)
    for y, cb, cr in [(sweep, mid, mid), (mid, sweep, mid), (mid, mid, sweep),
                      tuple(rng.integers(0, 256, (3, 64, 64), dtype=np.uint8))]:
        want = oracle.ycc_to_rgb(y, cb, cr)
        jax_out = J.ycc_to_rgb_x(jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr), jnp)
        np.testing.assert_array_equal(np.asarray(jax_out), want)
        got = D.ycc_to_rgb_planes_x(*(torch.from_numpy(a) for a in (y, cb, cr)))
        np.testing.assert_array_equal(np.stack([c.numpy() for c in got], axis=-1), want)


def _jpeg(arr: np.ndarray, sampling: str) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", quality=85,
                              subsampling={"444": 0, "422": 1, "420": 2}[sampling])
    return buf.getvalue()


@pytest.mark.parametrize("sampling", ["444", "422", "420", "gray"])
def test_whole_image_decode_matches_jax_trace(sampling):
    """decode_plane then window_to_rgba over a whole image (window = the
    image) against the JAX package's ``decode_rgb_trace`` and the owned
    host decoder, at every sampling and on edges that are not
    MCU-aligned."""
    rng = np.random.default_rng(6)
    x = np.linspace(0, 255, 67, dtype=np.float32)
    arr = np.empty((45, 67, 3), np.uint8)
    arr[..., 0] = x[None, :].astype(np.uint8)
    arr[..., 1] = rng.integers(0, 256, (45, 67), dtype=np.uint8)
    arr[..., 2] = x[None, ::-1].astype(np.uint8)
    data = _jpeg(arr[..., 1] if sampling == "gray" else arr, "444" if sampling == "gray"
                 else sampling)
    ref = decode_baseline_jpeg(data)
    comps, qtabs, geom, width, height = decode_coefficients(data)
    zz = [c[:, np.asarray(J.ZIGZAG)] for c in comps]
    jax_rgb = J.decode_rgb_trace([jnp.asarray(z.astype(np.int32)) for z in zz],
                                 [jnp.asarray(q) for q in qtabs], geom, 64, width, height, jnp)
    np.testing.assert_array_equal(np.asarray(jax_rgb), ref)
    planes, geoms = [], []
    for z, q, (by, bx, comp_w, comp_h, h_exp, v_exp) in zip(zz, qtabs, geom):
        planes.append(D.decode_plane(torch.from_numpy(z.astype(np.int16)),
                                     torch.from_numpy(np.asarray(q, np.int32)), bx))
        geoms.append((h_exp, v_exp, 0, 0, comp_h, comp_w))
    got = D.window_to_rgba(planes, geoms, height, width).numpy()
    np.testing.assert_array_equal(got[..., :3], ref)
    assert (got[..., 3] == 255).all()
