"""The port's JPEG encoders against the JAX package on byte-packed bands
and under the JAX package's batch knob.

- Packed bands: an (H, W) uint32 band of little-endian RGBA is the same
  image as its (H, W, 4) uint8 view. The port's host
  ``StreamingJpegEncoder``, ``TorchStreamingJpegEncoder(device="cpu")``
  (host arrays and tensors), ``JpegEncoder`` and ``core._encode_jpeg`` give
  the JAX package's ``backend="numpy"`` bytes on it, also in a stream that
  mixes packed and interleaved bands with held-back rows; ``encode_jpeg``
  and bands of other kinds raise or convert as the JAX package's do.
- ``STITCH_TPU_DEVICE_BATCH`` (tests/unit/test_device_entropy.py:358-410):
  the JAX package sends the restart groups of N bands in one dispatch; the
  port reads no such variable and dispatches each band's groups on their
  own. With the variable at 1, 2, 3 and 8 the port's bytes equal the JAX
  package's ``StreamingJpegEncoder`` at that batch on ``backend="jax"``
  and its host tier's, for full and partial batches, a tail, a tail-only
  ``finish`` and 4:2:0, and over four virtual CPU shards; the encoder's
  kernel wrappers run once a band's groups and once a tail, plus
  re-packs, whatever the variable says.

Everything is integer: bytes must be equal.
"""

import numpy as np
import pytest
import torch

import image_stitch_tpu
import image_stitch_tpu_torch
from image_stitch_tpu.codecs.jpeg import encoder as jax_encoder
from image_stitch_tpu.core import CoreStreamingConcatenator
from image_stitch_tpu.types import PngHeader as JaxPngHeader
from image_stitch_tpu_torch.codecs.jpeg import encoder
from image_stitch_tpu_torch.errors import StitchError
from image_stitch_tpu_torch.ops import jpeg_entropy_device as jed
from image_stitch_tpu_torch.parallel.mesh import row_slabs
from image_stitch_tpu_torch.types import PngHeader
from tests.test_torch_sharded_concat import noisy_tile
from tests.utils.fixtures import png_from_array

torch.set_num_threads(1)


def noise(h: int, w: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (h, w, 4), dtype=np.uint8)


def photo(h: int, w: int, seed: int) -> np.ndarray:
    """Smooth ramps and a little noise: a few bits a pixel at q85."""
    rng = np.random.default_rng(seed)
    a = np.empty((h, w, 4), np.uint8)
    a[..., 0] = np.linspace(0, 255, w, dtype=np.float32)[None, :].astype(np.uint8)
    a[..., 1] = np.linspace(0, 255, h, dtype=np.float32)[:, None].astype(np.uint8)
    a[..., 2] = 128
    a[..., 3] = 255
    return (a.astype(np.int16) + rng.integers(-6, 7, a.shape)).clip(0, 255).astype(np.uint8)


def packed(img: np.ndarray) -> np.ndarray:
    return img.view(np.uint32).reshape(img.shape[:2])


def stream(enc, bands) -> bytes:
    out = b"".join(b"".join(enc.encode_band(b)) for b in bands)
    return out + b"".join(enc.finish())


def cut(img: np.ndarray, band_h: int) -> list[np.ndarray]:
    return [img[y : y + band_h] for y in range(0, img.shape[0], band_h)]


def jax_bytes(img, band_h: int, backend: str = "numpy", **kw) -> bytes:
    h, w = img.shape[:2]
    return stream(jax_encoder.StreamingJpegEncoder(w, h, 85, backend=backend, **kw),
                  cut(img, band_h))


def torch_encoder(img, **kw):
    h, w = img.shape[:2]
    return encoder.TorchStreamingJpegEncoder(w, h, 85, device="cpu", **kw)


# --------------------------------------------------------------------------- #
# Packed bands
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("sampling,ri", [("444", 0), ("444", 1), ("420", 1)])
@pytest.mark.parametrize("form", ["host", "torch_array", "torch_tensor"])
def test_packed_band_gives_the_jax_package_bytes(form, sampling, ri):
    """The fault repaired: the host encoder truncated each word to its low
    byte and the torch encoder raised; both now view the band as RGBA."""
    img = noise(16, 24, 3)
    kw = dict(sampling=sampling, restart_interval_rows=ri)
    want = jax_bytes(img, 16, **kw)
    assert jax_bytes(packed(img), 16, **kw) == want
    if form == "host":
        got = stream(encoder.StreamingJpegEncoder(24, 16, 85, **kw), [packed(img)])
    elif form == "torch_array":
        got = stream(torch_encoder(img, **kw), [packed(img)])
    else:
        got = stream(torch_encoder(img, **kw), [torch.from_numpy(packed(img))])
    assert got == want


@pytest.mark.parametrize("sampling", ["444", "420"])
def test_jpeg_encoder_on_a_packed_band(sampling):
    """``JpegEncoder.encode_to_buffer`` reads its input's bytes: a packed
    band's are the image's, in both packages and on both tiers."""
    img = noise(16, 24, 3)
    want = jax_encoder.JpegEncoder(24, 16, 85, "numpy", sampling).encode_to_buffer(img)
    assert jax_encoder.JpegEncoder(24, 16, 85, "numpy", sampling).encode_to_buffer(
        packed(img)) == want
    for backend in ("torch", "numpy"):
        enc = encoder.JpegEncoder(24, 16, 85, backend, sampling, device="cpu")
        assert enc.encode_to_buffer(packed(img)) == want


def test_encode_jpeg_on_a_packed_band_raises_as_the_jax_package():
    """``encode_jpeg`` casts its input to uint8 before it reads the bytes,
    in both packages: a packed band's words are cut to their low bytes, too
    few for the image, and both raise the same ValueError."""
    img = packed(noise(16, 24, 4))
    with pytest.raises(ValueError) as jax_err:
        jax_encoder.encode_jpeg(img, 24, 16, 85, "numpy")
    for backend in ("torch", "numpy"):
        with pytest.raises(ValueError) as port_err:
            encoder.encode_jpeg(img, 24, 16, 85, backend, device="cpu")
        assert str(port_err.value) == str(jax_err.value)
    rgba = noise(16, 24, 4)
    assert encoder.encode_jpeg(rgba, 24, 16, 85, device="cpu") == jax_encoder.encode_jpeg(
        rgba, 24, 16, 85, "numpy")


@pytest.mark.parametrize("ri", [0, 2])
@pytest.mark.parametrize("which", ["host", "torch"])
def test_mixed_packed_and_interleaved_stream_with_held_back_rows(which, ri):
    """Bands of 5 and 11 rows (never whole MCU strips, so rows are held
    back and joined), packed and interleaved in turn, host arrays and
    tensors: the JAX package's bytes of the image in one form."""
    img = noise(48, 40, 5)
    want = jax_bytes(img, 48, restart_interval_rows=ri)
    parts, y, i = [], 0, 0
    while y < 48:
        h = (5, 11)[i % 2]
        band = img[y : y + h]
        band = packed(band) if i % 2 == 0 else band
        if which == "torch" and i % 3 == 0:
            band = torch.from_numpy(band.copy())
        parts.append(band)
        y, i = y + h, i + 1
    if which == "host":
        enc = encoder.StreamingJpegEncoder(40, 48, 85, restart_interval_rows=ri)
    else:
        enc = torch_encoder(img, restart_interval_rows=ri)
    assert stream(enc, parts) == want


@pytest.mark.parametrize("band", [
    np.zeros((16, 24), np.uint8),  # rank 2, one byte a pixel: cannot be RGBA
    np.zeros((16, 24), np.int64),  # rank 2, eight bytes a pixel
])
def test_other_rank_2_bands_raise_as_the_jax_package(band):
    with pytest.raises(ValueError):
        stream(jax_encoder.StreamingJpegEncoder(24, 16, 85, backend="numpy"), [band])
    with pytest.raises(ValueError):
        stream(encoder.StreamingJpegEncoder(24, 16, 85), [band])
    with pytest.raises(ValueError):
        stream(encoder.TorchStreamingJpegEncoder(24, 16, 85, device="cpu"), [band])


def test_wider_rank_3_bands_convert_as_the_jax_package():
    """An (H, W, 4) int32 band is cast to uint8 by both packages' host
    encoders: the same bytes."""
    band = noise(16, 24, 6).astype(np.int32) * 3
    want = stream(jax_encoder.StreamingJpegEncoder(24, 16, 85, backend="numpy"), [band])
    assert stream(encoder.StreamingJpegEncoder(24, 16, 85), [band]) == want
    assert stream(encoder.TorchStreamingJpegEncoder(24, 16, 85, device="cpu"), [band]) == want


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_encode_jpeg_stage_takes_packed_bands_and_refuses_others(backend):
    """``_encode_jpeg`` of the concatenators: a rank-2 uint32 band is
    encoded as the JAX package's; a 16-bit band raises StitchError in
    both."""
    img = noise(24, 32, 7)
    opts = {"inputs": [png_from_array(img)], "layout": {"columns": 1},
            "outputFormat": "jpeg", "backend": backend}
    port = image_stitch_tpu_torch.TorchStreamingConcatenator(opts, device="cpu")
    ref = CoreStreamingConcatenator({**opts, "backend": "numpy"})
    hdr = dict(width=32, height=24, bit_depth=8, color_type=6)
    bands = [packed(img[:16]), img[16:]]
    got = b"".join(port._encode_jpeg(iter(bands), PngHeader(**hdr)))
    assert got == b"".join(ref._encode_jpeg(iter(bands), JaxPngHeader(**hdr)))
    bad = [img.astype(np.uint16)]
    with pytest.raises(Exception) as jax_err:
        b"".join(ref._encode_jpeg(iter(bad), JaxPngHeader(**hdr)))
    with pytest.raises(StitchError) as port_err:
        b"".join(port._encode_jpeg(iter(bad), PngHeader(**hdr)))
    assert type(jax_err.value).__name__ == "StitchError"
    assert str(port_err.value) == str(jax_err.value)


def test_packed_tensor_is_viewed_not_copied():
    img = noise(8, 16, 8)
    t = torch.from_numpy(packed(img).copy())
    view = encoder.unpack_rgba(t)
    assert view.shape == (8, 16, 4) and view.dtype == torch.uint8
    assert view.data_ptr() == t.data_ptr()
    np.testing.assert_array_equal(view.numpy(), img)
    host = encoder.unpack_rgba(packed(img))
    assert np.shares_memory(host, img) and host.shape == (8, 16, 4)
    assert encoder.unpack_rgba(img) is img


# --------------------------------------------------------------------------- #
# The JAX package's batch knob
# --------------------------------------------------------------------------- #


@pytest.fixture
def dispatches(monkeypatch):
    """Calls of the encoder's kernel wrappers (quantize, symbols, layout,
    pack), counted on the CPU, where they run their plain versions."""
    calls = {"quantize": 0, "symbol_streams": 0, "group_layout": 0, "pack_merge": 0}

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    for name in ("symbol_streams", "group_layout", "pack_merge"):
        monkeypatch.setattr(jed, name, counted(name, getattr(jed, name)))
    monkeypatch.setattr(jed, "jpeg_quantize", counted("quantize", jed.jpeg_quantize))
    monkeypatch.setattr(jed, "jpeg_quantize_420", counted("quantize", jed.jpeg_quantize_420))
    return calls


def band_dispatches(img_h: int, band_h: int, ri: int, mcu: int) -> int:
    """Dispatches of a stream of ``band_h``-row bands: one for each submit
    of whole restart groups, and one for a shorter last group."""
    group = ri * mcu
    mains, held = 0, 0
    for y in range(0, img_h, band_h):
        rows = held + min(band_h, img_h - y)
        mains += rows >= group
        held = rows % group
    # finish pads the held rows to whole MCU rows: a group, or a tail.
    padded = -(-held // mcu) * mcu
    return mains + (padded == group) + (0 < padded < group)


def assert_dispatched(calls: dict, counters, want: int):
    assert calls["quantize"] == want
    for k in ("symbol_streams", "group_layout", "pack_merge"):
        assert calls[k] == want + counters.repacks


@pytest.mark.parametrize("batch,band_h", [(1, 32), (2, 32), (3, 32), (8, 32), (1, 16),
                                          (2, 16), (3, 16), (8, 16)])
def test_batch_knob_bytes_equal_the_jax_package(batch, band_h, dispatches, monkeypatch):
    """88 rows at restart rows 2: five 16-row groups and a one-MCU-row
    tail. Bands of 32 rows give 2-group submits; at a batch of 3 the JAX
    package sends a partial batch before the tail; at 8 its batch never
    fills; bands of 16 end with a tail-only submit from ``finish``. The
    port's bytes equal the JAX device encoder's at that batch and its host
    tier's, with one dispatch a submit."""
    img = noise(88, 64, 31)
    monkeypatch.setenv("STITCH_TPU_DEVICE_BATCH", str(batch))
    ref = jax_bytes(img, band_h, restart_interval_rows=2)
    assert jax_bytes(img, band_h, "jax", restart_interval_rows=2) == ref
    counters = image_stitch_tpu_torch.EncodeCounters()
    enc = torch_encoder(img, restart_interval_rows=2, counters=counters)
    assert stream(enc, cut(img, band_h)) == ref
    assert_dispatched(dispatches, counters, band_dispatches(88, band_h, 2, 8))


@pytest.mark.parametrize("batch", [1, 3, 4])
def test_batch_knob_420_bytes_equal_the_jax_package(batch, dispatches, monkeypatch):
    """4:2:0 (16-row MCUs) at restart rows 1 on a photo-like image of 12
    groups in 16-row bands (batches that fill exactly), then 186 rows, whose
    last 10 rows ``finish`` pads to a whole group (no tail)."""
    monkeypatch.setenv("STITCH_TPU_DEVICE_BATCH", str(batch))
    img = photo(192, 48, 9)
    kw = dict(restart_interval_rows=1, sampling="420")
    ref = jax_bytes(img, 16, **kw)
    assert jax_bytes(img, 16, "jax", **kw) == ref
    counters = image_stitch_tpu_torch.EncodeCounters()
    assert stream(torch_encoder(img, counters=counters, **kw), cut(img, 16)) == ref
    assert_dispatched(dispatches, counters, 12)
    img = img[:186]
    ref = jax_bytes(img, 16, **kw)
    assert jax_bytes(img, 16, "jax", **kw) == ref
    assert stream(torch_encoder(img, **kw), cut(img, 16)) == ref


def test_batch_knob_over_a_mesh_equals_the_jax_package(monkeypatch):
    """Four virtual CPU shards with the variable at 3: the JAX package
    reshards each batch of 3 bands by row_slabs; the port splits each band
    so. The same bytes, and the port dispatches each band's slabs."""
    monkeypatch.setenv("STITCH_TPU_DEVICE_BATCH", "3")
    opts = {"inputs": [png_from_array(noisy_tile(i)) for i in range(4)],
            "layout": {"columns": 2}, "outputFormat": "jpeg", "bandHeight": 16,
            "jpegRestartIntervalRows": 1}
    counters = image_stitch_tpu_torch.EncodeCounters()
    got = image_stitch_tpu_torch.concat_to_buffer({**opts, "mesh": 4}, device="cpu",
                                                  counters=counters)
    assert got == image_stitch_tpu.concat_to_buffer({**opts, "mesh": 4})
    assert got == image_stitch_tpu.concat_to_buffer({**opts, "backend": "numpy"})
    # 160 rows in 10 bands of 2 groups, each split over the four shards.
    slabs = 10 * sum(r1 > r0 for r0, r1 in row_slabs(16, 4, 8))
    assert (counters.bands, counters.mesh_dispatches) == (10, slabs)
