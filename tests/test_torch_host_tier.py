"""The torch port's host tier (``backend="numpy"`` / ``"oracle"``) against
the JAX package's ``backend="numpy"``.

Every path of the port on its host tier: grid to JPEG (4:4:4 and 4:2:0,
restart rows 0, 1 and 2, an odd width, a partial tail), PNG (8-bit and
16-bit), positioned compositing (PNG and JPEG, an exact rational tie
included), a grid of JPEG tiles and ``host_threads=2``; through
``concat_to_buffer``, ``concat_streaming``, ``concat_arrays``,
``JpegEncoder`` and ``encode_jpeg``. Every case asserts equal bytes (or
arrays) with ``image_stitch_tpu`` on the same seeded inputs, under the same
native-library state. The host encoder's sub-tiers (fused native, split
native, the numpy oracle) mirror tests/unit/test_fused_encode_band.py.

A host-tier run calls no torch function and launches no kernel: the
counters show host-tier bands only, and ``device="cuda"`` is never read. A
card-path run (``device="cpu"``, the kernels' plain versions) codes no band
on the host tier.
"""

import threading

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import image_stitch_tpu
import image_stitch_tpu.native
from image_stitch_tpu.codecs.jpeg.encoder import StreamingJpegEncoder as JaxStreamingJpegEncoder
import image_stitch_tpu_torch as port
import image_stitch_tpu_torch.native
from image_stitch_tpu_torch.codecs.jpeg import encoder as enc_mod
from image_stitch_tpu_torch.codecs.jpeg.encoder import StreamingJpegEncoder
from image_stitch_tpu_torch.codecs.jpeg.tables import quality_scaled_tables
from image_stitch_tpu_torch.core import TorchStreamingConcatenator
from image_stitch_tpu_torch.io.deflate import StreamingDeflator
from image_stitch_tpu_torch.native import (
    NativeDeflator,
    jpeg_quant_band_420_native,
    native_available,
)
from image_stitch_tpu_torch.ops import backend as B
from image_stitch_tpu_torch.ops import kernels as K
from image_stitch_tpu_torch.ops.backend import (
    NumpyBackend,
    get_backend,
    resolve_backend_name,
)
from image_stitch_tpu_torch.ops.device import TorchBackend
from tests.utils.fixtures import jpeg_from_array, png_from_array

torch.set_num_threads(1)

needs_native = pytest.mark.skipif(not native_available(), reason="native tier unavailable")
KERNELS = ("pack_merge", "filter_select", "composite_segments", "idct_dequant", "ycc_rgba",
           "fdct_quant", "symbol_streams", "group_layout")


class TorchCalls(TorchFunctionMode):
    """Records every torch function called inside it."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.calls.append(getattr(func, "__name__", str(func)))
        return func(*args, **(kwargs or {}))


def photo(h, w, seed):
    """Colour ramps plus noise, opaque."""
    rng = np.random.default_rng(seed)
    img = np.empty((h, w, 4), np.uint8)
    img[..., 0] = np.linspace(0, 255, w, dtype=np.float32)[None, :].astype(np.uint8)
    img[..., 1] = np.linspace(0, 255, h, dtype=np.float32)[:, None].astype(np.uint8)
    img[..., 2] = rng.integers(0, 256, (h, w), dtype=np.uint8)
    img[..., 3] = 255
    return img


def grid(w=48, h=40, fmt="jpeg", n=4, columns=2, **kw):
    tiles = [png_from_array(photo(h, w, s)) for s in range(n)]
    return {"inputs": tiles, "layout": {"columns": columns}, "outputFormat": fmt,
            "bandHeight": 16, **kw}


def jax_numpy(opts):
    return image_stitch_tpu.concat_to_buffer({**opts, "backend": "numpy"})


def host_run(opts, backend="numpy"):
    """The port's host tier with the default device ("cuda", never read):
    its bytes, its counters and the torch functions it called."""
    counters = port.EncodeCounters()
    with TorchCalls() as mode:
        out = port.concat_to_buffer({**opts, "backend": backend}, counters=counters)
    return out, counters, mode.calls


HOST_COUNTS = {"host_tier_bands", "deflate_batches", "deflate_batches_overlapped"}


def assert_host_only(counters, calls):
    """Host-tier counts only (bands, and the PNG deflate's batches): no
    kernel launch, no device count, no torch call."""
    assert counters.host_tier_bands > 0
    assert all(v == 0 for k, v in vars(counters).items() if k not in HOST_COUNTS)
    assert all(getattr(K, k).launches == 0 for k in KERNELS)
    assert calls == []


@pytest.fixture(autouse=True)
def no_card(monkeypatch):
    """The host tier must not look for a card: make any look fail loudly."""
    for k in KERNELS:
        monkeypatch.setattr(getattr(K, k), "launches", 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


# --------------------------------------------------------------------------- #
# Paths
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("ri", [0, 1, 2])
@pytest.mark.parametrize("sampling", ["444", "420"])
@pytest.mark.parametrize("backend", ["numpy", "oracle"])
def test_grid_jpeg_matches_jax_numpy(backend, sampling, ri):
    opts = grid(jpegSampling=sampling, jpegRestartIntervalRows=ri, jpegQuality=85)
    out, counters, calls = host_run(opts, backend)
    assert out == jax_numpy(opts)
    assert_host_only(counters, calls)
    if ri:
        assert sum(out.count(bytes([0xFF, 0xD0 + i])) for i in range(8)) > 0


@pytest.mark.parametrize("ri", [0, 1, 2])
@pytest.mark.parametrize("sampling", ["444", "420"])
def test_odd_width_and_partial_tail(sampling, ri):
    """A 100 x 20 canvas: the width pads by edge repetition (4 columns at
    4:4:4, 12 at 4:2:0) and a band of 4 rows is held back for finish()."""
    opts = grid(w=50, h=20, n=2, jpegSampling=sampling, jpegRestartIntervalRows=ri)
    out, counters, calls = host_run(opts)
    assert out == jax_numpy(opts)
    assert_host_only(counters, calls)


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("level", [1, 6])
def test_png_matches_jax_numpy(depth, level):
    """Three tiles in two columns, the last cell empty: 2 x 21 rows in
    bands of 8 (16-bit), 2 x 37 rows in bands of 16 (8-bit)."""
    if depth == 16:
        rng = np.random.default_rng(depth + level)
        tiles = [png_from_array(rng.integers(0, 65536, (21, 33, 4), dtype=np.uint16),
                                bit_depth=16) for _ in range(3)]
        opts = {"inputs": tiles, "layout": {"columns": 2}, "outputFormat": "png",
                "bandHeight": 8}
    else:
        opts = grid(w=45, h=37, fmt="png", n=3)
    opts["pngCompressionLevel"] = level
    out, counters, calls = host_run(opts)
    assert out == jax_numpy(opts)
    assert_host_only(counters, calls)
    assert counters.host_tier_bands == (6 if depth == 16 else 5)


def sprites(n=8, seed=7):
    """A 120 x 90 sprite and ``n`` smaller ones of random alpha at random
    places and z indices."""
    rng = np.random.default_rng(seed)
    inputs = [{"source": png_from_array(rng.integers(0, 256, (90, 120, 4), dtype=np.uint8)),
               "x": 0, "y": 0}]
    for _ in range(n):
        h, w = (int(v) for v in rng.integers(15, 50, 2))
        inputs.append({"source": png_from_array(rng.integers(0, 256, (h, w, 4), dtype=np.uint8)),
                       "x": int(rng.integers(0, 90)), "y": int(rng.integers(0, 70)),
                       "z_index": int(rng.integers(0, 4))})
    return inputs


def tie_inputs():
    """(As=2, Ad=6, s=5, d=174) over a transparent canvas: an exact
    round-half tie, where float64 rounds down (131) and the integer
    rational up (132); the host tier must give the JAX host tier's 131."""
    base = np.zeros((8, 8, 4), np.uint8)
    base[..., :3], base[..., 3] = 174, 6
    top = np.zeros((8, 8, 4), np.uint8)
    top[..., :3], top[..., 3] = 5, 2
    return [{"source": png_from_array(base), "x": 4, "y": 4, "z_index": 0},
            {"source": png_from_array(top), "x": 4, "y": 4, "z_index": 1},
            {"source": png_from_array(photo(24, 24, 3)), "x": 20, "y": 0, "z_index": 2}]


@pytest.mark.parametrize("fmt", ["png", "jpeg"])
@pytest.mark.parametrize("case", ["random_alpha", "tie"])
def test_positioned_matches_jax_numpy(case, fmt):
    inputs = sprites() if case == "random_alpha" else tie_inputs()
    opts = {"inputs": inputs, "bandHeight": 32 if case == "random_alpha" else 8,
            "outputFormat": fmt}
    out, counters, calls = host_run(opts)
    assert out == jax_numpy(opts)
    assert_host_only(counters, calls)


def test_positioned_tie_is_the_float64_oracle():
    """The tie band's pixel through stream_bands: 131, as the host oracle
    rounds it (the card's integer rational would give 132 and replay)."""
    opts = {"inputs": tie_inputs(), "bandHeight": 8, "outputFormat": "png",
            "backend": "numpy"}
    got = np.vstack(list(TorchStreamingConcatenator(opts).stream_bands()))
    want = np.vstack(list(image_stitch_tpu.CoreStreamingConcatenator(opts).stream_bands()))
    np.testing.assert_array_equal(got, want)
    assert got[4, 4, 0] == 131


@pytest.mark.parametrize("ri", [0, 1])
def test_grid_of_jpeg_tiles_decodes_on_the_host(ri):
    """JPEG tiles into JPEG: the device-decode gate is off on the host
    tier, as it is off the device in the JAX package."""
    tiles = [jpeg_from_array(photo(32, 48, s)[..., :3], quality=88) for s in range(4)]
    opts = {"inputs": tiles, "layout": {"columns": 2}, "outputFormat": "jpeg",
            "bandHeight": 16, "jpegRestartIntervalRows": ri}
    out, counters, calls = host_run(opts)
    assert out == jax_numpy(opts)
    assert_host_only(counters, calls)
    assert counters.decode_tile_bands == counters.decode_bands_on_device == 0


def batched(mode, fmt):
    """A 512 x 1040 canvas in bands of 512 rows, a grid of four 256 x 520
    tiles or sprites over a 512 x 1040 photo: a band's filtered rows
    (512 x 2049 bytes) pass the deflate's 1 MB batch, so the PNG stream has
    three batches, the last band's 16 rows in the final one."""
    if mode == "grid":
        tiles = [png_from_array(photo(520, 256, s)) for s in range(4)]
        return {"inputs": tiles, "layout": {"columns": 2}, "outputFormat": fmt,
                "bandHeight": 512}
    inputs = [{"source": png_from_array(photo(1040, 512, 9)), "x": 0, "y": 0}] + sprites()
    return {"inputs": inputs, "bandHeight": 512, "outputFormat": fmt}


@pytest.mark.parametrize("fmt", ["png", "jpeg"])
@pytest.mark.parametrize("mode", ["grid", "positioned", "grid_batches", "positioned_batches"])
def test_host_threads_give_the_same_bytes(mode, fmt):
    if mode.endswith("_batches"):
        opts = batched(mode.removesuffix("_batches"), fmt)
    else:
        opts = (grid(fmt=fmt, n=6, columns=3, jpegRestartIntervalRows=1) if mode == "grid"
                else {"inputs": sprites(), "bandHeight": 32, "outputFormat": fmt})
    serial, _, _ = host_run({**opts, "hostThreads": 1})
    threaded, counters, calls = host_run({**opts, "hostThreads": 2})
    assert serial == threaded == jax_numpy({**opts, "hostThreads": 2})
    assert_host_only(counters, calls)


@pytest.mark.parametrize("fmt", ["png", "jpeg"])
def test_without_the_native_library(monkeypatch, fmt):
    """Both packages with their C++ host library off: the numpy filter and
    deflate, the plain quantize and the numpy Huffman coder."""
    for native in (image_stitch_tpu.native, image_stitch_tpu_torch.native):
        monkeypatch.setattr(native, "_LIB", None)
        monkeypatch.setattr(native, "_LIB_TRIED", True)
    opts = grid(w=24, h=16, fmt=fmt, jpegRestartIntervalRows=1)
    counters = port.EncodeCounters()
    out = port.concat_to_buffer({**opts, "backend": "numpy"}, counters=counters)
    assert out == jax_numpy(opts)
    assert counters.host_tier_bands > 0 and counters.bands == counters.png_bands == 0


# --------------------------------------------------------------------------- #
# The PNG deflate's worker at host_threads 1
# --------------------------------------------------------------------------- #


COMPRESS_BATCH = NativeDeflator._compress_batch


def deflate_threads() -> set:
    return {t for t in threading.enumerate() if t.name.startswith("stitch-deflate")}


def serial_png(mode) -> dict:
    """The PNG options of a canvas at host_threads 1: ``batched``'s three
    batches, or (``"one_batch"``) a 96 x 80 grid of 31 KB of rows."""
    opts = grid(fmt="png") if mode == "one_batch" else batched(mode, "png")
    return {**opts, "hostThreads": 1}


@needs_native
@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("mode", ["grid", "positioned", "one_batch"])
def test_png_bytes_with_the_deflate_worker(mode, backend):
    """On the host tier and on the card path (the kernels' plain versions
    on the CPU): the first two of three batches compress on the
    concatenator's deflate worker and the final one on the caller's
    thread, and the bytes are the JAX package's. A canvas of one batch
    hands nothing to the worker, so no thread starts."""
    opts = serial_png(mode)
    counters = port.EncodeCounters()
    before = deflate_threads()
    c = TorchStreamingConcatenator({**opts, "backend": backend}, device="cpu",
                                   counters=counters)
    assert b"".join(c.stream()) == jax_numpy(opts)
    started = deflate_threads() - before
    c.close()
    if mode == "one_batch":
        assert (counters.deflate_batches, counters.deflate_batches_overlapped) == (1, 0)
        assert started == set()
    else:
        assert counters.deflate_batches == 3
        assert counters.deflate_batches_overlapped == counters.deflate_batches - 1
        (worker,) = started
        assert not worker.is_alive()


class InFlight:
    """Stands for ``NativeDeflator._compress_batch`` and counts the batches
    in flight: a batch is in flight from the moment the deflator takes the
    function to compress it (as it submits the batch) to the end of its
    compression. ``hold`` runs before each compression."""

    def __init__(self, hold=lambda args: None):
        self.hold, self.lock = hold, threading.Lock()
        self.now = self.most = 0
        self.threads: list[int] = []

    def __get__(self, obj, cls=None):
        with self.lock:
            self.now += 1
            self.most = max(self.most, self.now)

        def run(*args):
            try:
                self.threads.append(threading.get_ident())
                self.hold(args)
                return COMPRESS_BATCH(*args)
            finally:
                with self.lock:
                    self.now -= 1

        return run


@needs_native
@pytest.mark.parametrize("mode", ["grid", "positioned"])
def test_at_most_one_batch_in_flight(monkeypatch, mode):
    """At host_threads 1 no batch is submitted while another is in flight,
    the final one included; at host_threads 2 the pool keeps more."""
    spy = InFlight()
    monkeypatch.setattr(NativeDeflator, "_compress_batch", spy)
    opts = serial_png(mode)
    out, counters, _ = host_run(opts)
    assert out == jax_numpy(opts)
    assert spy.most == 1 and len(spy.threads) == counters.deflate_batches == 3
    assert spy.threads.count(threading.get_ident()) == 1
    pooled = InFlight()
    monkeypatch.setattr(NativeDeflator, "_compress_batch", pooled)
    assert host_run({**opts, "hostThreads": 2})[0] == out
    assert pooled.most > 1


@needs_native
def test_the_next_band_reaches_the_deflator_while_a_batch_compresses(monkeypatch):
    """Each batch on the worker waits, before it compresses, until the
    caller has begun to push the band after the one that made it: the
    caller decodes and filters that band while the batch is in flight.
    Compressed on the caller's thread, the wait could never end."""
    pushes = []
    cond = threading.Condition()
    orig_push = StreamingDeflator.push

    def push(self, data):
        with cond:
            pushes.append(len(data))
            cond.notify_all()
        return orig_push(self, data)

    waits = []

    def hold(args):
        if args[5]:  # the final batch, on the caller's thread
            return
        batch = len(waits) + 1
        with cond:
            waits.append(cond.wait_for(lambda: len(pushes) > batch, timeout=30))

    monkeypatch.setattr(StreamingDeflator, "push", push)
    monkeypatch.setattr(NativeDeflator, "_compress_batch", InFlight(hold))
    opts = serial_png("grid")
    assert host_run(opts)[0] == jax_numpy(opts)
    assert waits == [True, True] and len(pushes) == 3


@needs_native
def test_a_worker_batch_error_reaches_the_caller(monkeypatch):
    """A batch that fails on the worker raises on the caller's thread, at
    the next flush, before that flush's batch is submitted; the
    concatenator's next job gives the right bytes."""
    opts = serial_png("grid")

    def broken(*args):
        if threading.current_thread() is not threading.main_thread():
            raise RuntimeError("planted batch fault")
        return COMPRESS_BATCH(*args)

    counters = port.EncodeCounters()
    c = TorchStreamingConcatenator({**opts, "backend": "numpy"}, counters=counters)
    monkeypatch.setattr(NativeDeflator, "_compress_batch", staticmethod(broken))
    with pytest.raises(RuntimeError, match="planted batch fault"):
        b"".join(c.stream())
    assert (counters.deflate_batches, counters.deflate_batches_overlapped) == (1, 1)
    monkeypatch.undo()
    assert b"".join(c.stream()) == jax_numpy(opts)
    c.close()


@needs_native
def test_one_deflate_thread_serves_every_job():
    """Twenty PNG jobs on one concatenator: one worker thread, made at the
    first job's first batch, ended by ``close()``; a one-shot call ends its
    own."""
    opts = {**serial_png("grid"), "backend": "numpy"}
    want = jax_numpy(opts)
    before = deflate_threads()
    c = TorchStreamingConcatenator(opts)
    assert b"".join(c.stream()) == want
    (worker,) = deflate_threads() - before
    count = threading.active_count()
    for _ in range(19):
        assert b"".join(c.stream()) == want
    assert threading.active_count() == count and deflate_threads() - before == {worker}
    c.close()
    assert not worker.is_alive()
    assert port.concat_to_buffer(opts) == want
    assert deflate_threads() - before == set()


@needs_native
def test_concurrent_png_jobs_share_the_buffer_pool():
    """More job threads than cores, each with its deflate worker, all
    taking and returning the native module's pooled buffers, with the
    interpreter switching threads every microsecond: every job gives the
    JAX package's bytes."""
    import os
    import sys

    opts = {**serial_png("grid"), "backend": "numpy"}
    want = jax_numpy(opts)
    outs, errors = [], []

    def jobs():
        try:
            c = TorchStreamingConcatenator(opts)
            try:
                for _ in range(3):
                    outs.append(b"".join(c.stream()))
            finally:
                c.close()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=jobs) for _ in range((os.cpu_count() or 1) + 2)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert len(outs) == 3 * len(threads) and all(o == want for o in outs)


# --------------------------------------------------------------------------- #
# Entry points
# --------------------------------------------------------------------------- #


def test_concat_streaming_and_to_file(tmp_path):
    opts = {**grid(), "backend": "oracle"}
    want = jax_numpy(opts)
    assert b"".join(port.concat_streaming(opts)) == want
    port.concat_to_file(opts, tmp_path / "out.jpg")
    assert (tmp_path / "out.jpg").read_bytes() == want


@pytest.mark.parametrize("output", ["array", "png", "jpeg"])
def test_concat_arrays(output):
    arrays = [photo(20, 30, s) for s in range(3)] + [photo(20, 30, 9)[..., :3]]
    counters = port.EncodeCounters()
    got = port.concat_arrays(arrays, {"columns": 2}, output, backend="numpy", counters=counters)
    want = image_stitch_tpu.concat_arrays(arrays, layout={"columns": 2}, output=output,
                                          backend="numpy")
    if output == "array":
        np.testing.assert_array_equal(got, want)
        assert counters.host_tier_bands == 0
    else:
        assert got == want and counters.host_tier_bands > 0


@pytest.mark.parametrize("sampling", ["444", "420"])
@pytest.mark.parametrize("backend", ["numpy", "oracle"])
def test_jpeg_encoder_and_encode_jpeg(backend, sampling):
    rgba = photo(27, 45, 5)
    want = image_stitch_tpu.encode_jpeg(rgba, 45, 27, 80, "numpy", sampling)
    counters = port.EncodeCounters()
    with TorchCalls() as mode:
        enc = port.JpegEncoder(45, 27, 80, backend, sampling, counters=counters)
        assert isinstance(enc._inner, StreamingJpegEncoder)
        assert enc.encode_to_buffer(rgba.tobytes()) == want
        assert port.encode_jpeg(rgba, 45, 27, 80, backend, sampling) == want
    assert mode.calls == [] and counters.host_tier_bands == 1 and counters.bands == 0


def test_jpeg_encoder_strips_match_jax():
    rgba = photo(20, 24, 6)
    ref = image_stitch_tpu.JpegEncoder(24, 20, 85, "numpy")
    enc = port.JpegEncoder(24, 20, 85, "numpy")
    for lo in range(0, 20, 8):
        strip = rgba[lo:lo + 8].tobytes()
        assert b"".join(enc.encode_strip(strip)) == b"".join(ref.encode_strip(strip))
    assert b"".join(enc.finish()) == b"".join(ref.finish())


# --------------------------------------------------------------------------- #
# Backend names and routing
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name,want", [("numpy", "numpy"), ("oracle", "numpy"),
                                       ("torch", "torch"), ("auto", "torch")])
def test_resolve_backend_name(name, want, monkeypatch):
    """Each name at the auto threshold's size; "auto" is the policy: the
    host tier under the threshold or at an unknown size, over it the cost
    model, which picks the device over the CPU's instant link (or wherever
    the C++ host library is missing)."""
    monkeypatch.delenv("STITCH_TPU_PREFER_DEVICE", raising=False)
    monkeypatch.delenv("STITCH_TPU_LINK_PROFILE", raising=False)
    monkeypatch.setattr(B, "_LINK_PROFILES", {})
    big = B.AUTO_DEVICE_THRESHOLD_PIXELS
    small = "numpy" if name == "auto" else want
    assert resolve_backend_name(name, big, "cpu") == want
    assert resolve_backend_name(name) == resolve_backend_name(name, big - 1, "cpu") == small
    for px, key in ((big, want), (big - 1, small)):
        backend = get_backend(name, "cpu", canvas_pixels=px)
        assert isinstance(backend, NumpyBackend if key == "numpy" else TorchBackend)


@pytest.mark.parametrize("name", ["jax", "tpu", "native", ""])
def test_other_backend_names_raise(name):
    """The JAX package's device names force the device as "torch" does, at
    any size (its types.py: "force device"); "native" and "" raise."""
    if name in ("jax", "tpu"):
        assert resolve_backend_name(name) == resolve_backend_name(name, 1) == "torch"
        core = TorchStreamingConcatenator({**grid(), "backend": name}, device="cpu")
        assert core.backend == "torch" and core.device == torch.device("cpu")
        return
    with pytest.raises(port.StitchError, match="not a path of image_stitch_tpu_torch"):
        resolve_backend_name(name)
    with pytest.raises(port.StitchError, match="not a path of image_stitch_tpu_torch"):
        TorchStreamingConcatenator({**grid(), "backend": name}, device="cpu")


def test_numpy_backend_is_shared_and_matches_jax():
    band = photo(16, 20, 2)
    ours = get_backend("numpy")
    assert ours is get_backend("oracle")
    prev = photo(1, 20, 3).reshape(-1)
    got = ours.png_filter_band(band, prev)
    want = image_stitch_tpu.ops.backend.NumpyBackend().png_filter_band(band, prev)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_host_tier_leaves_the_device_unread():
    core = TorchStreamingConcatenator({**grid(), "backend": "numpy"}, device="cuda")
    assert core.backend == "numpy" and core.device is None
    with pytest.raises(port.StitchError, match="(?i)cuda"):
        TorchStreamingConcatenator(grid(), device="cuda")


@pytest.mark.parametrize("fmt", ["png", "jpeg"])
def test_card_path_codes_no_band_on_the_host_tier(fmt):
    opts = grid(fmt=fmt, jpegRestartIntervalRows=1)
    counters = port.EncodeCounters()
    out = port.concat_to_buffer(opts, device="cpu", counters=counters)
    assert out == jax_numpy(opts)
    assert counters.host_tier_bands == 0
    assert (counters.bands if fmt == "jpeg" else counters.png_bands) > 0


def test_tensor_band_into_the_host_tier_raises():
    enc = StreamingJpegEncoder(16, 16)
    with pytest.raises(port.StitchError, match="host tier takes host arrays"):
        list(enc.encode_band(torch.zeros((16, 16, 4), dtype=torch.uint8)))
    core = TorchStreamingConcatenator({**grid(fmt="png"), "backend": "numpy"})
    header = port.PngHeader(width=16, height=16, bit_depth=8, color_type=6)
    with pytest.raises(port.StitchError, match="host tier takes host arrays"):
        list(core._encode_png(iter([torch.zeros((16, 16, 4), dtype=torch.uint8)]), header))


# --------------------------------------------------------------------------- #
# The host encoder's sub-tiers (tests/unit/test_fused_encode_band.py)
# --------------------------------------------------------------------------- #


def encode(w, h, bands, tier, quality=85, sampling="444", ri=0):
    """One stream through the host encoder's ``tier``: "fused" (the native
    fused band call), "split" (native quantize, then the native entropy
    coder) or "oracle" (the plain torch quantize on the CPU and the numpy
    Huffman coder)."""
    enc = StreamingJpegEncoder(w, h, quality, sampling, ri)
    if tier != "fused":
        enc._fused_native_band = lambda band: None
    if tier == "oracle":
        enc._native_coder = None
        blocks = (enc_mod._band_to_blocks_numpy_420 if sampling == "420"
                  else enc_mod._band_to_blocks_numpy)
        enc._quantize_band = lambda band: blocks(
            np.concatenate([band, np.repeat(band[:, -1:], enc._pad_w, axis=1)], axis=1)
            if enc._pad_w else band, enc.luma_q, enc.chroma_q)
    out = b""
    for band in bands:
        out += b"".join(enc.encode_band(band))
    return out + b"".join(enc.finish())


def jax_encode(w, h, bands, quality=85, sampling="444", ri=0):
    enc = JaxStreamingJpegEncoder(w, h, quality, sampling=sampling, restart_interval_rows=ri)
    out = b""
    for band in bands:
        out += b"".join(enc.encode_band(band))
    return out + b"".join(enc.finish())


def tiers_equal(w, h, bands, **kw):
    want = jax_encode(w, h, bands, **kw)
    for tier in ("fused", "split", "oracle"):
        assert encode(w, h, bands, tier, **kw) == want, tier
    return want


@needs_native
@pytest.mark.parametrize("quality", [50, 85, 95])
def test_fused_split_oracle_equal(quality):
    rng = np.random.default_rng(3)
    bands = [rng.integers(0, 256, (16, 128, 4), dtype=np.uint8) for _ in range(4)]
    tiers_equal(128, 64, bands, quality=quality)


@needs_native
def test_tiers_equal_odd_width_padding():
    rng = np.random.default_rng(5)
    tiers_equal(100, 32, [rng.integers(0, 256, (32, 100, 4), dtype=np.uint8)])


@needs_native
def test_tiers_equal_partial_tail():
    rng = np.random.default_rng(7)
    tiers_equal(64, 20, [rng.integers(0, 256, (20, 64, 4), dtype=np.uint8)])


@needs_native
@pytest.mark.parametrize("shape", [(32, 64), (48, 100), (20, 30)])
def test_420_tiers_equal(shape):
    h, w = shape
    rng = np.random.default_rng(h * 100 + w)
    tiers_equal(w, h, [rng.integers(0, 256, (h, w, 4), dtype=np.uint8)], sampling="420")


@needs_native
def test_native_420_quant_matches_the_oracle():
    rng = np.random.default_rng(13)
    for q in (50, 85, 95):
        lq, cq = quality_scaled_tables(q)
        for h, w in [(16, 16), (32, 64), (64, 128)]:
            band = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
            for a, b in zip(jpeg_quant_band_420_native(band, lq, cq),
                            enc_mod._band_to_blocks_numpy_420(band, lq, cq)):
                np.testing.assert_array_equal(a, b)


@needs_native
@pytest.mark.parametrize("sampling", ["444", "420"])
@pytest.mark.parametrize("ri", [1, 2, 3])
def test_restart_groups_tiers_equal(sampling, ri):
    """Bands that do not align to restart groups, so groups span band
    edges, and a short final group (test_fused_restart_groups_equal_split's
    cases)."""
    rng = np.random.default_rng(13 * ri + (0 if sampling == "444" else 1))
    w = 100 if sampling == "444" else 96
    h = 8 * (16 if sampling == "420" else 8) + (8 if sampling == "444" else 16)
    band_h = 3 * (16 if sampling == "420" else 8)
    bands = [rng.integers(0, 256, (min(band_h, h - row), w, 4), dtype=np.uint8)
             for row in range(0, h, band_h)]
    out = tiers_equal(w, h, bands, sampling=sampling, ri=ri)
    assert sum(out.count(bytes([0xFF, 0xD0 + i])) for i in range(8)) > 0


def test_oracle_coder_warns_above_two_megapixels(monkeypatch):
    monkeypatch.setattr(image_stitch_tpu_torch.native, "_LIB", None)
    monkeypatch.setattr(image_stitch_tpu_torch.native, "_LIB_TRIED", True)
    with pytest.warns(RuntimeWarning, match="backend='torch'"):
        StreamingJpegEncoder(2048, 1025)
