"""Host bands through the JPEG encoder's staging ring (``ops.staging``).

``TorchJpegEncoder`` copies a host band as it lies, alpha and all, into the
next buffer of a ring of ``STAGING_RING`` buffers and uploads it from
there. Here, on the CPU: the bytes equal the port's host tier's and the JAX
package's ``backend="numpy"`` for 4:4:4 and 4:2:0, restart intervals 0 and
2, a width padded to whole MCUs, a short last band and more bands than the
ring holds, from RGBA and RGB arrays, contiguous or not; a source array
written over right after its submit changes nothing; the ring keeps its
``STAGING_RING`` buffers; and the counters count host bands only.
"""

import functools

import numpy as np
import pytest
import torch

from image_stitch_tpu.codecs.jpeg import encoder as jax_encoder
from image_stitch_tpu_torch.codecs.jpeg import encoder
from image_stitch_tpu_torch.ops.counters import EncodeCounters
from image_stitch_tpu_torch.ops.staging import STAGING_RING, BandStaging

torch.set_num_threads(1)

H = 136  # four 32-row bands and a short last one of 8 rows
BAND = 32


def image(width: int) -> np.ndarray:
    """Smooth ramps under noise, with an alpha the encoder must ignore."""
    rng = np.random.default_rng(width)
    x = np.linspace(0, 255, width)[None, :, None]
    y = np.linspace(0, 255, H)[:, None, None]
    base = np.concatenate([np.broadcast_to(x, (H, width, 1)), np.broadcast_to(y, (H, width, 1)),
                           np.full((H, width, 1), 128.0), np.zeros((H, width, 1))], axis=2)
    img = (base + rng.integers(-20, 21, base.shape)).clip(0, 255).astype(np.uint8)
    img[..., 3] = rng.integers(0, 256, (H, width), dtype=np.uint8)
    return img


def bands_of(img: np.ndarray) -> list[np.ndarray]:
    return [img[y : y + BAND] for y in range(0, img.shape[0], BAND)]


def stream(enc, bands) -> bytes:
    out = b"".join(b"".join(enc.encode_band(b)) for b in bands)
    return out + b"".join(enc.finish())


@functools.lru_cache(maxsize=None)
def reference(width: int, sampling: str, ri: int) -> bytes:
    """The JAX package's host bytes, which the port's host tier must give
    too."""
    bands = bands_of(image(width))
    want = stream(jax_encoder.StreamingJpegEncoder(width, H, 85, "numpy", sampling, ri), bands)
    assert stream(encoder.StreamingJpegEncoder(width, H, 85, sampling, ri), bands) == want
    return want


def host_form(img: np.ndarray, form: str) -> np.ndarray:
    """The image as the encoder is handed it: RGBA or RGB, contiguous, or
    an RGB view of the RGBA array, or a window into a wider canvas."""
    if form == "rgba":
        return img
    if form == "rgb":
        return np.ascontiguousarray(img[..., :3])
    if form == "rgb_view":
        return img[..., :3]
    wide = np.zeros((img.shape[0], img.shape[1] + 13, 4), np.uint8)
    wide[:, 5 : 5 + img.shape[1]] = img
    return wide[:, 5 : 5 + img.shape[1]]


def torch_encoder(width: int, sampling: str, ri: int, counters=None):
    return encoder.TorchStreamingJpegEncoder(width, H, 85, sampling, ri, device="cpu",
                                             counters=counters)


@pytest.mark.parametrize("form", ["rgba", "rgb", "rgb_view", "window"])
@pytest.mark.parametrize("width", [96, 100])
@pytest.mark.parametrize("ri", [0, 2])
@pytest.mark.parametrize("sampling", ["444", "420"])
def test_staged_bands_give_the_reference_bytes(sampling, ri, width, form):
    """Every band goes up through the ring, whatever its channels and
    strides: the JAX package's bytes. Width 100 is padded to whole MCUs;
    the last band is short and held back to ``finish``."""
    counters = EncodeCounters()
    enc = torch_encoder(width, sampling, ri, counters)
    bands = bands_of(host_form(image(width), form))
    if form in ("rgb_view", "window"):
        assert not bands[0].flags.c_contiguous
    assert stream(enc, bands) == reference(width, sampling, ri)
    assert counters.staged_uploads == counters.bands >= 1 + STAGING_RING
    assert counters.staging_stalls == 0  # no copy is ever in flight on the CPU


@pytest.mark.parametrize("ri", [0, 2])
@pytest.mark.parametrize("sampling", ["444", "420"])
def test_source_written_over_after_submit(sampling, ri):
    """The ring holds the encoder's own copy: once ``encode_band`` has
    submitted a band, the caller may write over its array."""
    img = image(96)
    enc = torch_encoder(96, sampling, ri)
    out = []
    for band in bands_of(img):
        band = band.copy()
        out += enc.encode_band(band)
        band[...] = 255 - band
    out += enc.finish()
    assert b"".join(out) == reference(96, sampling, ri)


@pytest.mark.parametrize("n_bands", [1, STAGING_RING, 2 * STAGING_RING + 1])
def test_ring_keeps_its_buffers(n_bands):
    """The encoder makes its ring on its first host band; the ring holds
    ``STAGING_RING`` buffers at most and hands the same ones out again."""
    enc = torch_encoder(96, "444", 0)._dev_encoder
    assert enc._staging is None
    band = image(96)[:BAND]
    ptrs = []
    for _ in range(n_bands):
        enc.wait(enc.submit(band))
        ptrs.append(tuple(b.data_ptr() for b in enc._staging._buffers if b is not None))
    held = [b for b in enc._staging._buffers if b is not None]
    assert len(held) == min(n_bands, STAGING_RING)
    assert all(p == ptrs[-1] for p in ptrs[STAGING_RING - 1 :])
    assert enc.counters.staged_uploads == n_bands


@pytest.mark.parametrize("first", ["host", "tensor"])
def test_tensor_bands_bypass_the_ring(first):
    """Host arrays and tensors in one stream: only the host bands are
    staged, and the bytes are the reference's."""
    counters = EncodeCounters()
    enc = torch_encoder(96, "444", 0, counters)
    bands = bands_of(image(96))
    host = [(i % 2 == 0) == (first == "host") for i in range(len(bands))]
    given = [b if h else torch.from_numpy(b.copy()) for b, h in zip(bands, host)]
    assert stream(enc, given) == reference(96, "444", 0)
    assert counters.staged_uploads == sum(host)
    assert counters.bands == len(bands)


class Event:
    """A CUDA event's two calls, with a copy done or still in flight."""

    def __init__(self, done: bool):
        self.done = done
        self.synchronized = False

    def query(self) -> bool:
        return self.done

    def synchronize(self) -> None:
        self.synchronized = True


@pytest.mark.parametrize("done", [True, False])
def test_ring_counts_an_acquire_that_stalls(done):
    """``acquire`` waits on the slot's event either way; it counts a stall
    only when the copy behind the event was still in flight."""
    ring = BandStaging("cpu")
    slot, _ = ring.acquire(64)
    event = ring._events[slot] = Event(done)
    for _ in range(STAGING_RING):
        ring.acquire(64)
    assert event.synchronized
    assert (ring.waits, ring.stalls) == (1, 0 if done else 1)
