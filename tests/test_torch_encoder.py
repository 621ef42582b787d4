"""The torch port's streaming band encoder against the JAX package's.

``TorchJpegEncoder`` on CPU tensors (the kernels' plain versions) and
``image_stitch_tpu.ops.jpeg_entropy_device.DeviceJpegEncoder`` (JAX on the
CPU) encode the same seeded bands; their entropy-coded bytes must be equal,
including the overflow paths: a per-block budget that a re-pack fixes, a
budget nothing fixes (host coding), too little pooled capacity, and a
dispatch whose start bits could pass 2^31 (host coding). The
port's counters say which path each band took.
"""

import numpy as np
import pytest
import torch

from image_stitch_tpu.codecs.jpeg.tables import quality_scaled_tables
from image_stitch_tpu.ops.jpeg_entropy_device import DeviceJpegEncoder
from image_stitch_tpu_torch.codecs.jpeg.encoder import local_words_for_quality
from image_stitch_tpu_torch.ops import jpeg_entropy_device as E
from image_stitch_tpu_torch.ops import kernels as K
from image_stitch_tpu_torch.ops.jpeg_entropy_device import EncodeCounters, TorchJpegEncoder
from tests.utils.torch_port import TABLES

torch.set_num_threads(1)


def photo_band(rng, h: int, w: int) -> np.ndarray:
    """Smooth gradients plus mild noise, opaque."""
    x = np.linspace(0, 255, w)[None, :]
    y = np.linspace(0, 255, h)[:, None]
    band = np.stack([x + 0 * y, 0.5 * (x + y), 255 - x + 0 * y, np.full((h, w), 255.0)], -1)
    band[..., :3] += rng.normal(0, 6, (h, w, 3))
    return np.clip(band, 0, 255).astype(np.uint8)


def noise_band(rng, h: int, w: int) -> np.ndarray:
    """Every pixel 0 or 255 per channel: the most bits a block can take."""
    return (rng.integers(0, 2, (h, w, 4)) * 255).astype(np.uint8)


def gray_band(h: int, w: int) -> np.ndarray:
    return np.full((h, w, 4), 128, np.uint8)


def encode_both(bands, quality=85, ri=0, sampling="444", local_words=None, cap=3):
    """Entropy-coded bytes of ``bands`` from the JAX encoder and the torch
    encoder, submitted and drained one band at a time, and the port's
    counters."""
    lq, cq = quality_scaled_tables(quality)
    lw = local_words or local_words_for_quality(quality)
    ref = DeviceJpegEncoder(lq, cq, *TABLES, cap_bits_per_px=cap,
                            restart_interval_rows=ri, sampling=sampling, local_words=lw)
    counters = EncodeCounters()
    port = TorchJpegEncoder(lq, cq, *TABLES, device="cpu", cap_bits_per_px=cap,
                            restart_interval_rows=ri, sampling=sampling, local_words=lw,
                            counters=counters)
    outs = []
    for enc in (ref, port):
        out = b"".join(enc.wait(enc.submit(b)) for b in bands)
        outs.append(out + enc.flush())
    return outs[0], outs[1], counters


@pytest.mark.parametrize("sampling", ["444", "420"])
def test_carried_stream_matches_jax(sampling):
    rng = np.random.default_rng(1)
    h = 32 if sampling == "420" else 16
    bands = [photo_band(rng, h, 64) for _ in range(3)]
    ref, got, c = encode_both(bands, sampling=sampling)
    assert got == ref
    assert (c.bands, c.repacks, c.host_fallback_bands) == (3, 0, 0)


@pytest.mark.parametrize("sampling", ["444", "420"])
def test_restart_groups_with_tail_match_jax(sampling):
    """Whole groups of 2 MCU rows, then a last band whose final group is a
    1-row tail."""
    rng = np.random.default_rng(2)
    mh = 16 if sampling == "420" else 8
    bands = [photo_band(rng, 4 * mh, 48), photo_band(rng, 4 * mh, 48),
             photo_band(rng, 3 * mh, 48)]
    ref, got, c = encode_both(bands, ri=2, sampling=sampling)
    assert got == ref
    assert (c.bands, c.repacks, c.host_fallback_bands) == (3, 0, 0)


@pytest.mark.parametrize("ri", [0, 1])
def test_block_budget_overflow_codes_on_host(ri):
    """q100 on 0/255 noise: blocks exceed 24 words (768 bits), the largest
    budget, so the band is coded on the host; the next band goes on."""
    rng = np.random.default_rng(3)
    bands = [noise_band(rng, 16, 32), gray_band(16, 32)]
    ref, got, c = encode_both(bands, quality=100, ri=ri)
    assert got == ref
    assert c.host_fallback_bands == 1 and c.repacks == 0


def test_block_budget_overflow_repacks_with_larger_budget():
    """A 2-word budget at q85: the band is re-packed on the device with a
    12-word budget, which later bands keep."""
    rng = np.random.default_rng(4)
    bands = [photo_band(rng, 16, 48) for _ in range(2)]
    ref, got, c = encode_both(bands, ri=1, local_words=2)
    assert got == ref
    assert c.repacks == 1 and c.host_fallback_bands == 0


def test_budget_checked_against_the_band_in_flight():
    """Two bands in flight under a 1-word budget: the first band's re-pack
    raises the budget to 12 words, and the second band, packed with 1 word,
    is still checked against 1 word and re-packed. The JAX encoder checks it
    against the raised budget and keeps its clipped words (523 bytes, not
    522); the port matches the JAX encoder run with a budget that fits."""
    rng = np.random.default_rng(4)
    bands = [photo_band(rng, 16, 48) for _ in range(2)]
    lq, cq = quality_scaled_tables(85)
    truth = DeviceJpegEncoder(lq, cq, *TABLES, restart_interval_rows=1, local_words=12)
    want = b"".join(truth.wait(truth.submit(b)) for b in bands) + truth.flush()
    counters = EncodeCounters()
    enc = TorchJpegEncoder(lq, cq, *TABLES, device="cpu", restart_interval_rows=1,
                           local_words=1, counters=counters)
    handles = [enc.submit(b) for b in bands]
    got = b"".join(enc.wait(h) for h in handles) + enc.flush()
    assert got == want
    assert counters.repacks == 2 and counters.host_fallback_bands == 0


def test_pooled_capacity_overflow_repacks():
    """1 bit/px of pooled capacity for noisy content: re-packed on the
    device with the capacity the exact group bit counts need."""
    rng = np.random.default_rng(5)
    bands = [noise_band(rng, 16, 48), photo_band(rng, 16, 48)]
    ref, got, c = encode_both(bands, ri=1, cap=1)
    assert got == ref
    assert c.repacks >= 1 and c.host_fallback_bands == 0


def test_carried_capacity_overflow_codes_on_host():
    """The carried stream has no re-pack: a band over its capacity is coded
    on the host, and later bands get twice the capacity."""
    rng = np.random.default_rng(6)
    bands = [noise_band(rng, 16, 48), photo_band(rng, 16, 48)]
    ref, got, c = encode_both(bands, ri=0, cap=1)
    assert got == ref
    assert c.host_fallback_bands == 1 and c.repacks == 0


def test_submit_rejects_device_arrays():
    """``submit`` takes a tensor on the encoder's device as it lies, with
    the host array's bytes; a tensor on another device raises (no silent
    copy), and so does one that is not an (H, W, C >= 3) uint8 band."""
    rng = np.random.default_rng(7)
    band = photo_band(rng, 16, 32)
    lq, cq = quality_scaled_tables(85)
    outs = []
    for b in (band, torch.from_numpy(band.copy())):
        enc = TorchJpegEncoder(lq, cq, *TABLES, device="cpu")
        outs.append(enc.wait(enc.submit(b)) + enc.flush())
    assert outs[0] == outs[1]
    with pytest.raises(ValueError):
        enc.submit(torch.zeros((8, 8, 4), dtype=torch.uint8, device="meta"))
    with pytest.raises(TypeError):
        enc.submit(torch.zeros((8, 8, 2), dtype=torch.uint8))
    with pytest.raises(TypeError):
        enc.submit(torch.zeros((8, 8, 4), dtype=torch.int32))


# --------------------------------------------------------------------------- #
# A dispatch whose start bits could pass 2^31
# --------------------------------------------------------------------------- #


def long_stream(monkeypatch, local_words: int) -> int:
    """Make the port's symbol stage report the bit counts of a dispatch of
    ceil(2^31 / (32 * local_words)) blocks, each at its full budget of
    ``local_words`` words, so that they sum past 2^31; the codes and lengths
    are zero-stride views. The layout (kernel and plain version) and the
    pack must not run. Returns the block count."""
    nb = -(-K.MAX_STREAM_BITS // (32 * local_words))

    def symbols(yb, cbb, crb, luts, n_groups=1, sampling="444", prev_dc=None):
        slots = torch.zeros((1, K.SYMBOL_SLOTS), dtype=torch.int32).expand(nb, -1)
        bits = torch.full((nb,), 32 * local_words, dtype=torch.int32)
        return slots, slots, bits, torch.zeros(3, dtype=torch.int32)

    def must_not_run(*args, **kwargs):
        raise AssertionError("a layout or a pack ran on a stream past 2^31 bits")

    monkeypatch.setattr(E, "symbol_streams", symbols)
    for mod, name in ((E, "group_layout"), (E, "group_layout_plain"), (E, "pack_merge"),
                      (K, "group_layout"), (K, "pack_merge_plain")):
        monkeypatch.setattr(mod, name, must_not_run)
    return nb


def test_stream_bound_at_2_31_bits():
    """The bound is blocks x (budget + 1) words x 32 bits: the largest
    dispatch fits, one block more does not, and pack_merge refuses it
    before any check of its tensors, so nothing launches."""
    lw = 24
    nb = (K.MAX_STREAM_BITS - 1) // (32 * (lw + 1))
    assert K.stream_fits_int32(nb, lw) and not K.stream_fits_int32(nb + 1, lw)
    slots = torch.zeros((1, K.SYMBOL_SLOTS), dtype=torch.int32).expand(nb + 1, -1)
    with pytest.raises(ValueError, match="2\\^31"):
        K.pack_merge(slots, slots, torch.zeros(1, dtype=torch.int32), lw, 64)


def test_pack_functions_refuse_streams_past_2_31_bits(monkeypatch):
    """Given bit counts summing past 2^31, the restart-group pack returns
    no words, and the carried pack no words but the exact int64 total and
    the next band's base, computed from the bit counts alone."""
    lw = 24
    nb = long_stream(monkeypatch, lw)
    blocks = [torch.zeros((1, 64), dtype=torch.int16)] * 3
    assert E.pack_groups_from_blocks(*blocks, {}, 1, 64, local_words=lw) == (None,) * 4
    base = torch.tensor(5, dtype=torch.int64)
    words, total, new_dc, max_bb = E.entropy_pack_carried(
        *blocks, {}, torch.zeros(3, dtype=torch.int32), base, 64, local_words=lw)
    assert words is None and max_bb is None
    assert int(total) == 5 + nb * 32 * lw >= K.MAX_STREAM_BITS


@pytest.mark.parametrize("ri", [0, 1])
def test_stream_past_2_31_bits_codes_on_host(monkeypatch, ri):
    """A band whose dispatch could pass 2^31 start bits is coded on the host
    from its exact blocks: the JAX encoder's bytes, no layout, no pack."""
    rng = np.random.default_rng(8)
    bands = [photo_band(rng, 16, 48)]
    long_stream(monkeypatch, local_words_for_quality(85))
    ref, got, c = encode_both(bands, ri=ri)
    assert got == ref
    assert (c.bands, c.repacks, c.host_fallback_bands) == (1, 0, 1)
