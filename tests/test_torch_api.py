"""The torch port's public entry points beside ``image_stitch_tpu.api``'s.

``concat_to_stream``, ``StreamingConcatenator`` (``__iter__``, ``stream``,
``to_stream``), the deprecated ``concat`` and ``concat_arrays`` ("array",
"png", "jpeg"; grid and positioned) on ``device="cpu"`` against the JAX
package's same calls on its host tier: equal bytes, equal arrays (tolerance
0). Mirrors the API cases of tests/integration/test_grid_api.py.
"""

import io
import warnings

import numpy as np
import pytest
import torch

import image_stitch_tpu
import image_stitch_tpu.types
import image_stitch_tpu_torch as port
from image_stitch_tpu_torch.types import PositionedImage
from tests.utils.fixtures import png_from_array, random_rgba

torch.set_num_threads(1)


def grid_opts(fmt="png", n=4, columns=2, **kw):
    tiles = [png_from_array(random_rgba(24, 16, s)) for s in range(n)]
    return {"inputs": tiles, "layout": {"columns": columns}, "outputFormat": fmt, **kw}


def reference(opts):
    return image_stitch_tpu.concat_to_buffer({**opts, "backend": "numpy"})


def test_every_entry_point_is_exported():
    for name in ("concat_to_buffer", "concat_streaming", "concat_to_file", "concat_to_stream",
                 "StreamingConcatenator", "concat", "concat_arrays"):
        assert name in port.__all__ and callable(getattr(port, name))


@pytest.mark.parametrize("fmt", ["png", "jpeg"])
def test_concat_to_stream_matches_jax_package(fmt):
    opts = grid_opts(fmt)
    want = reference(opts)
    assert b"".join(port.concat_to_stream(opts, device="cpu")) == want
    assert b"".join(image_stitch_tpu.concat_to_stream({**opts, "backend": "numpy"})) == want


@pytest.mark.parametrize("fmt", ["png", "jpeg"])
def test_streaming_concatenator_three_ways(fmt):
    opts = grid_opts(fmt)
    want = reference(opts)
    by_iter = b"".join(port.StreamingConcatenator(opts, device="cpu"))
    by_stream = b"".join(port.StreamingConcatenator(opts, device="cpu").stream())
    buf = io.BytesIO()
    port.StreamingConcatenator(opts, device="cpu").to_stream(buf)
    assert by_iter == by_stream == buf.getvalue() == want


def test_streaming_concatenator_yields_chunks():
    chunks = list(port.StreamingConcatenator(grid_opts(), device="cpu"))
    assert len(chunks) >= 4  # signature, IHDR, IDAT(s), IEND
    assert chunks[0][:8] == b"\x89PNG\r\n\x1a\n"


def test_to_stream_equals_to_file(tmp_path):
    opts = grid_opts()
    buf = io.BytesIO()
    port.concat_to_stream(opts, device="cpu").to_stream(buf)
    path = tmp_path / "out.png"
    port.concat_to_file(opts, path, device="cpu")
    assert buf.getvalue() == path.read_bytes()


def test_counters_reach_the_encoder():
    counters = port.EncodeCounters()
    b"".join(port.concat_to_stream(grid_opts("jpeg"), device="cpu", counters=counters))
    assert counters.bands > 0


def test_deprecated_concat_warns_and_matches():
    opts = grid_opts()
    with pytest.warns(DeprecationWarning):
        got = port.concat(opts, device="cpu")
    with pytest.warns(DeprecationWarning):
        want = image_stitch_tpu.concat({**opts, "backend": "numpy"})
    assert got == want


@pytest.mark.parametrize("layout", [{"columns": 2}, {"rows": 2}, {"width": 40}])
def test_concat_arrays_array_matches_jax_package(layout):
    arrays = [random_rgba(16 + 2 * s, 12, s) for s in range(4)]
    got = port.concat_arrays(arrays, layout=layout, device="cpu")
    want = image_stitch_tpu.concat_arrays(arrays, layout=layout, backend="numpy")
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_concat_arrays_convenience():
    a, b = random_rgba(6, 6, 8), random_rgba(6, 6, 9)
    out = port.concat_arrays([a, b], layout={"columns": 2}, device="cpu")
    np.testing.assert_array_equal(out, np.hstack([a, b]))


def test_concat_arrays_rgb_input_gets_alpha():
    rgb = np.random.default_rng(3).integers(0, 256, (8, 8, 3), dtype=np.uint8)
    got = port.concat_arrays([rgb, rgb], layout={"columns": 2}, device="cpu")
    want = image_stitch_tpu.concat_arrays([rgb, rgb], layout={"columns": 2}, backend="numpy")
    np.testing.assert_array_equal(got, want)
    assert got.shape == (8, 16, 4) and (got[:, :, 3] == 255).all()


@pytest.mark.parametrize("output,kw", [
    ("png", {}),
    ("jpeg", {}),
    ("jpeg", {"jpeg_quality": 60, "jpeg_sampling": "420"}),
    ("jpeg", {"jpegRestartIntervalRows": 1, "bandHeight": 16}),
])
def test_concat_arrays_encoded_matches_jax_package(output, kw):
    arrays = [random_rgba(24, 16, s) for s in range(4)]
    got = port.concat_arrays(arrays, layout={"columns": 2}, output=output, device="cpu", **kw)
    want = image_stitch_tpu.concat_arrays(arrays, layout={"columns": 2}, output=output,
                                          backend="numpy", **kw)
    assert isinstance(got, bytes) and got == want


def positioned(cls):
    bg = np.full((40, 48, 4), (10, 20, 30, 255), np.uint8)
    sprite = random_rgba(12, 10, 5)
    sprite[..., 3] = 128
    return [cls(x=0, y=0, source=bg), cls(x=5, y=7, source=sprite, z_index=1),
            cls(x=30, y=20, source=random_rgba(16, 16, 6), z_index=2)]


@pytest.mark.parametrize("output", ["array", "png", "jpeg"])
def test_concat_arrays_positioned_matches_jax_package(output):
    got = port.concat_arrays(positioned(PositionedImage), layout={}, output=output, device="cpu")
    want = image_stitch_tpu.concat_arrays(positioned(image_stitch_tpu.types.PositionedImage),
                                          layout={}, output=output, backend="numpy")
    if output == "array":
        assert got.shape == (40, 48, 4)
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def test_concat_arrays_16bit_stays_16bit():
    arr16 = np.random.default_rng(2).integers(0, 65536, (8, 8, 4), dtype=np.uint16)
    got = port.concat_arrays([arr16], layout={"columns": 1}, device="cpu")
    want = image_stitch_tpu.concat_arrays([arr16], layout={"columns": 1}, backend="numpy")
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, want)


def test_device_is_not_an_option():
    """``device`` stays out of the options: they hold only what the JAX
    package's do."""
    conc = port.StreamingConcatenator(grid_opts(), device="cpu")
    assert not hasattr(conc._core.options, "device")
    assert conc._core.device == torch.device("cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the error without a GPU")
@pytest.mark.parametrize("call", [
    lambda o: port.concat_to_stream(o),
    lambda o: port.StreamingConcatenator(o),
    lambda o: port.concat(o),
    lambda o: port.concat_arrays([random_rgba(8, 8, 1)], layout={"columns": 1}),
    lambda o: port.concat_arrays([random_rgba(8, 8, 1)], layout={"columns": 1}, output="jpeg"),
], ids=["concat_to_stream", "StreamingConcatenator", "concat", "arrays", "arrays_jpeg"])
def test_default_device_raises_without_a_gpu(call):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(Exception, match="(?i)cuda"):
            call(grid_opts())


# --------------------------------------------------------------------------- #
# JpegEncoder, encode_jpeg and the root re-exports
# --------------------------------------------------------------------------- #

# (width, height): on and off the 8- and 16-pixel MCU grids.
ENCODER_SIZES = [(32, 32), (37, 29), (50, 45), (8, 3)]


def rgba_image(width: int, height: int) -> np.ndarray:
    return np.random.default_rng(width * 1000 + height).integers(
        0, 256, (height, width, 4), dtype=np.uint8)


@pytest.mark.parametrize("sampling", ["444", "420"])
@pytest.mark.parametrize("width,height", ENCODER_SIZES)
def test_encode_jpeg_matches_jax_package(width, height, sampling):
    rgba = rgba_image(width, height)
    want = image_stitch_tpu.encode_jpeg(rgba, width, height, 85, "numpy", sampling)
    assert port.encode_jpeg(rgba, width, height, 85, "torch", sampling, device="cpu") == want
    assert port.encode_jpeg(rgba, width, height, sampling=sampling, device="cpu") == want


@pytest.mark.parametrize("sampling,quality", [("444", 85), ("420", 60), ("444", 100)])
@pytest.mark.parametrize("width,height", ENCODER_SIZES[:3])
def test_jpeg_encoder_strips_and_buffer_match_jax_package(width, height, sampling, quality):
    """``header`` / ``encode_strip`` (8-row strips as bytes, the last one
    short) / ``finish``, and ``encode_to_buffer``: the JAX package's bytes.
    The restart interval is 0, so this is the carried stream."""
    rgba = rgba_image(width, height)

    def by_strips(enc) -> bytes:
        out = b"".join(enc.header())
        for y in range(0, height, 8):
            out += b"".join(enc.encode_strip(rgba[y : y + 8].tobytes()))
        return out + b"".join(enc.finish())

    ref = image_stitch_tpu.JpegEncoder(width, height, quality, "numpy", sampling)
    want = by_strips(ref)
    counters = port.EncodeCounters()
    enc = port.JpegEncoder(width, height, quality, "torch", sampling, device="cpu",
                           counters=counters)
    assert (enc.width, enc.height, enc.quality) == (ref.width, ref.height, ref.quality)
    assert by_strips(enc) == want
    assert counters.bands > 0
    assert list(enc.finish()) == []  # finished: nothing more
    whole = port.JpegEncoder(width, height, quality, sampling=sampling, device="cpu")
    assert whole.encode_to_buffer(rgba.tobytes()) == want
    assert image_stitch_tpu.JpegEncoder(width, height, quality, "numpy",
                                        sampling).encode_to_buffer(rgba.tobytes()) == want


def test_streaming_encoder_takes_strip_bytes():
    rgba = rgba_image(24, 16)
    enc = port.TorchStreamingJpegEncoder(24, 16, device="cpu")
    out = b"".join(enc.encode_strip_bytes(rgba.tobytes())) + b"".join(enc.finish())
    assert out == image_stitch_tpu.encode_jpeg(rgba, 24, 16, 85, "numpy")


@pytest.mark.parametrize("backend", ["tpu", "jax", "native"])
def test_jpeg_encoder_refuses_other_backends(backend):
    """"tpu" and "jax" force the device, as in the JAX package, and give
    its bytes; "native" raises."""
    rgba = rgba_image(16, 16)
    if backend in ("tpu", "jax"):
        counters = port.EncodeCounters()
        enc = port.JpegEncoder(16, 16, 85, backend, device="cpu", counters=counters)
        want = image_stitch_tpu.encode_jpeg(rgba, 16, 16, 85, "numpy")
        assert isinstance(enc._inner, port.TorchStreamingJpegEncoder)
        assert enc.encode_to_buffer(rgba.tobytes()) == want
        assert port.encode_jpeg(rgba, 16, 16, 85, backend, device="cpu") == want
        assert counters.bands > 0 and counters.host_tier_bands == 0
        return
    with pytest.raises(port.StitchError, match="not a path of image_stitch_tpu_torch"):
        port.JpegEncoder(16, 16, 85, backend, device="cpu")
    with pytest.raises(port.StitchError, match="not a path of image_stitch_tpu_torch"):
        port.encode_jpeg(rgba, 16, 16, 85, backend, device="cpu")


def test_jpeg_encoder_validates_as_the_jax_package():
    for args in ((0, 8), (8, 0)):
        with pytest.raises(port.StitchError):
            port.JpegEncoder(*args, device="cpu")
    with pytest.raises(port.StitchError):
        port.JpegEncoder(8, 8, 101, device="cpu")
    with pytest.raises(port.StitchError):
        port.JpegEncoder(8, 8, 85, "auto", "422", device="cpu")


@pytest.mark.parametrize("call", [
    lambda: port.JpegEncoder(16, 16),
    lambda: port.encode_jpeg(rgba_image(16, 16), 16, 16),
], ids=["JpegEncoder", "encode_jpeg"])
def test_encoder_default_device_raises_without_a_gpu(call):
    if torch.cuda.is_available():
        pytest.skip("checks the error without a GPU")
    with pytest.raises(port.StitchError, match="(?i)cuda"):
        call()


RENAMED = {"CoreStreamingConcatenator": "TorchStreamingConcatenator",
           "StreamingJpegEncoder": "TorchStreamingJpegEncoder"}


@pytest.mark.parametrize("name", image_stitch_tpu.__all__)
def test_root_export(name):
    """Every name the JAX package's root exports is exported by the port's
    root, from the port's own modules; exactly two classes carry the port's
    names instead."""
    if name in RENAMED:
        assert name not in port.__all__ and not hasattr(port, name)
        name = RENAMED[name]
    assert name in port.__all__
    obj = getattr(port, name)
    module = getattr(obj, "__module__", None)
    if isinstance(module, str) and not isinstance(obj, (int, str, bytes, tuple, list)):
        assert not module.startswith("image_stitch_tpu."), module
    ref = getattr(image_stitch_tpu, {v: k for k, v in RENAMED.items()}.get(name, name))
    assert callable(obj) == callable(ref) and type(obj).__name__ == type(ref).__name__


def test_root_exports_only_add_the_ports_names():
    extra = set(port.__all__) - set(image_stitch_tpu.__all__)
    assert extra == {"TorchStreamingConcatenator", "TorchStreamingJpegEncoder", "EncodeCounters"}
    assert set(image_stitch_tpu.__all__) - set(port.__all__) == set(RENAMED)
    assert port.__version__ == image_stitch_tpu.__version__ and port.crc32 is port.png_crc32
