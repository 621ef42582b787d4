"""The torch port's grid/positioned -> JPEG and PNG slices, end to end.

``image_stitch_tpu_torch.concat_to_buffer(..., device="cpu")`` (the
kernels' plain versions) against ``image_stitch_tpu.concat_to_buffer`` with
``backend="jax"`` (JAX on the CPU) and ``backend="numpy"`` (the host tier):
the bytes must be equal. Mirrors tests/unit/test_jpeg_restart.py,
tests/unit/test_composite_device.py and, for the input formats the port's
own decoders carry (baseline and progressive JPEG, Adam7, palette,
grayscale and 16-bit PNG, arrays), tests/integration/test_mixed_formats.py
and test_format_matrix.py.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import image_stitch_tpu
import image_stitch_tpu.types
import image_stitch_tpu_torch
from image_stitch_tpu_torch.errors import StitchError
from image_stitch_tpu_torch.types import PositionedImage
from tests.conftest import PNGSUITE_DIR
from tests.utils.fixtures import png_from_array

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_image(w=96, h=80, seed=1):
    """Horizontal colour ramps plus noise, opaque (test_jpeg_restart's)."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 255, w).astype(np.uint8)
    img = np.zeros((h, w, 4), np.uint8)
    img[:, :, 0] = x[None, :]
    img[:, :, 1] = 128
    img[:, :, 2] = x[None, ::-1]
    img[:, :, 3] = 255
    return (img.astype(np.int16) + rng.integers(-12, 13, img.shape)).clip(0, 255).astype(np.uint8)


def grid_options(w, h, ri, sampling="444", quality=85, tiles=2):
    pngs = [png_from_array(make_image(w, h, seed=s)) for s in range(tiles)]
    return {
        "inputs": pngs, "layout": {"columns": 2}, "outputFormat": "jpeg",
        "jpegQuality": quality, "jpegSampling": sampling,
        "jpegRestartIntervalRows": ri, "bandHeight": 32,
    }


def for_jax(item):
    """The port's PositionedImage as the JAX package's, which that
    package's isinstance checks need; any other input as it is."""
    if isinstance(item, PositionedImage):
        return image_stitch_tpu.types.PositionedImage(
            item.x, item.y, item.source, z_index=item.z_index)
    return item


def host(opts, backend="numpy"):
    inputs = [for_jax(i) for i in opts["inputs"]]
    return image_stitch_tpu.concat_to_buffer({**opts, "inputs": inputs, "backend": backend})


def port(opts, **kw):
    return image_stitch_tpu_torch.concat_to_buffer(opts, device="cpu", **kw)


@pytest.mark.parametrize("sampling", ["444", "420"])
@pytest.mark.parametrize("ri", [0, 1, 4])
def test_grid_matches_jax_and_host(ri, sampling):
    opts = grid_options(96, 80, ri, sampling)
    counters = image_stitch_tpu_torch.EncodeCounters()
    got = port(opts, counters=counters)
    assert got == host(opts, "jax") == host(opts)
    assert counters.bands > 0 and counters.host_fallback_bands == 0


@pytest.mark.parametrize("sampling,h,ri", [("444", 88, 4), ("420", 112, 3)])
def test_tail_groups_match_jax_and_host(sampling, h, ri):
    """88 rows at ri=4: groups of 4, 4, 3 MCU rows; 112 rows of 4:2:0 at
    ri=3: groups of 3, 3, 1."""
    opts = grid_options(96, h, ri, sampling)
    assert port(opts) == host(opts, "jax") == host(opts)


@pytest.mark.parametrize("sampling", ["444", "420"])
@pytest.mark.parametrize("ri", [0, 2])
def test_widths_off_the_mcu_grid_match_host(ri, sampling):
    """A 90 x 37 canvas: neither width nor height is a multiple of 8 or 16,
    so the encoder pads both by edge repetition."""
    opts = grid_options(45, 37, ri, sampling)
    assert port(opts) == host(opts)


@pytest.mark.parametrize("quality", [1, 50, 100])
def test_qualities_match_host(quality):
    opts = grid_options(64, 48, 1, quality=quality)
    assert port(opts) == host(opts)


def pil_bytes(arr: np.ndarray, fmt: str, **kw) -> bytes:
    """``arr`` encoded by PIL, the independent codec of
    tests/integration/test_mixed_formats.py (JPEG drops alpha)."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr[:, :, :3] if fmt == "JPEG" else arr).save(buf, fmt, **kw)
    return buf.getvalue()


def suite(*names: str) -> list[str]:
    return [os.path.join(PNGSUITE_DIR, n) for n in names]


def input_case(name: str) -> dict:
    """Options of one input-format case: the inputs and the layout."""
    g = [make_image(32, 32, seed=s) for s in range(4)]
    if name == "jpeg_baseline":  # test_mixed_formats::test_interleaved_formats_2x2
        inputs = [pil_bytes(g[0], "PNG"), pil_bytes(g[1], "JPEG", quality=90),
                  pil_bytes(g[2], "JPEG", quality=90, subsampling=2), pil_bytes(g[3], "PNG")]
        return {"inputs": inputs, "layout": {"columns": 2}}
    if name == "jpeg_owned":  # test_mixed_with_owned_jpeg_tier
        return {"inputs": [pil_bytes(g[0], "JPEG", quality=85, subsampling=2),
                           pil_bytes(g[1], "PNG")],
                "layout": {"columns": 2}, "decoderOptions": {"forceOwned": True}}
    if name == "jpeg_progressive":  # test_mixed_progressive_jpeg_input
        jpeg = pil_bytes(g[2], "JPEG", quality=85, progressive=True)
        return {"inputs": [jpeg, jpeg], "layout": {"columns": 1},
                "decoderOptions": {"forceOwned": True}}
    if name == "jpeg_short_beside_png":  # test_mixed_sizes_transparent_padding
        return {"inputs": [pil_bytes(make_image(24, 60, seed=1), "PNG"),
                           pil_bytes(make_image(24, 30, seed=2), "JPEG", quality=90)],
                "layout": {"columns": 2}}
    if name == "png16_beside_jpeg":  # test_mixed_16bit_png_with_jpeg
        rng = np.random.default_rng(3)
        png16 = png_from_array(rng.integers(0, 65536, (16, 16, 4), dtype=np.uint16),
                               bit_depth=16)
        return {"inputs": [png16, pil_bytes(make_image(16, 16, seed=2), "JPEG", quality=90)],
                "layout": {"columns": 2}}
    if name == "arrays":  # uint8 RGBA and RGB, uint16 RGB arrays
        rng = np.random.default_rng(4)
        return {"inputs": [g[0], g[1][:, :, :3].copy(),
                           rng.integers(0, 65536, (32, 32, 3), dtype=np.uint16), g[3]],
                "layout": {"columns": 2}}
    # PngSuite (test_format_matrix's classes): interlaced, palette,
    # grayscale and 16-bit inputs, each with its Adam7 twin.
    files = {
        "adam7": ("basi0g01.png", "basi2c08.png", "basi3p08.png", "basi6a16.png"),
        "palette": ("basn3p01.png", "basn3p04.png", "basn3p08.png", "basi3p02.png"),
        "grayscale": ("basn0g02.png", "basn0g08.png", "basn4a08.png", "basi0g04.png"),
        "png16": ("basn0g16.png", "basn2c16.png", "basn4a16.png", "basn6a16.png"),
    }[name]
    return {"inputs": suite(*files), "layout": {"columns": 2}}


INPUT_CASES = ["jpeg_baseline", "jpeg_owned", "jpeg_progressive", "jpeg_short_beside_png",
               "png16_beside_jpeg", "arrays", "adam7", "palette", "grayscale", "png16"]


@pytest.mark.parametrize("fmt", ["png", "jpeg"])
@pytest.mark.parametrize("name", INPUT_CASES)
def test_input_formats_match_jax(name, fmt):
    """Each input format through the port's own decoders, to PNG and to
    JPEG (restart rows 1), equal to the JAX package's bytes."""
    opts = {**input_case(name), "outputFormat": fmt, "jpegRestartIntervalRows": 1,
            "bandHeight": 16}
    assert port(opts) == host(opts)


def test_heic_input_fails_like_jax():
    """A HEIC input reaches the port's own HEIC plugin: with no decode
    backend installed both packages raise, with the same message; with one,
    both decode it."""
    path = os.path.join(REPO, "tests", "fixtures", "heic", "fixture_64x48.heic")
    opts = {"inputs": [path, path], "layout": {"columns": 2}}
    try:
        want = host(opts)
    except image_stitch_tpu.errors.StitchError as e:
        with pytest.raises(StitchError) as got:
            port(opts)
        assert str(got.value) == str(e)
    else:
        assert port(opts) == want


def test_positioned_alpha_matches_host():
    """Positioned inputs with alpha over a background: compositing and the
    encode run in torch."""
    a = make_image(64, 48, seed=3)
    b = make_image(40, 40, seed=4)
    b[:, :, 3] = np.linspace(40, 220, 40).astype(np.uint8)[None, :]
    opts = {
        "inputs": [PositionedImage(0, 0, png_from_array(a)),
                   PositionedImage(30, 20, png_from_array(b))],
        "outputFormat": "jpeg", "backgroundColor": "#336699",
        "jpegRestartIntervalRows": 1, "bandHeight": 16,
    }
    assert port(opts) == host(opts)


@pytest.mark.parametrize("fmt", ["jpeg", "png"])
def test_streaming_and_file_entry_points(tmp_path, fmt):
    opts = {**grid_options(64, 48, 0), "outputFormat": fmt}
    whole = port(opts)
    assert b"".join(image_stitch_tpu_torch.concat_streaming(opts, device="cpu")) == whole
    path = tmp_path / f"out.{fmt}"
    image_stitch_tpu_torch.concat_to_file(opts, path, device="cpu")
    assert path.read_bytes() == whole


def png_grid_options(w, h, bit_depth=8, band=32, level=6):
    """A 2 x 2 grid of noisy w x h tiles to PNG output."""
    if bit_depth == 16:
        rng = np.random.default_rng(w * h)
        tiles = [png_from_array(rng.integers(0, 65536, (h, w, 4), dtype=np.uint16), bit_depth=16)
                 for _ in range(4)]
    else:
        tiles = [png_from_array(make_image(w, h, seed=s)) for s in range(4)]
    return {"inputs": tiles, "layout": {"columns": 2}, "outputFormat": "png",
            "bandHeight": band, "pngCompressionLevel": level}


@pytest.mark.parametrize("bit_depth", [8, 16])
@pytest.mark.parametrize("w,h,band", [(48, 40, 32), (45, 37, 16)])
def test_grid_png_matches_jax_and_host(bit_depth, w, h, band):
    """(45, 37, 16): a 90-px-wide canvas (neither a multiple of 4 nor 8)
    whose 16-row bands split the tiles, so the carry crosses bands inside a
    tile."""
    opts = png_grid_options(w, h, bit_depth, band)
    counters = image_stitch_tpu_torch.EncodeCounters()
    got = port(opts, counters=counters)
    assert got == host(opts, "jax") == host(opts)
    assert counters.png_bands == -(-2 * h // band)


@pytest.mark.parametrize("level", [1, 9])
def test_png_levels_match_host(level):
    opts = png_grid_options(45, 37, level=level)
    assert port(opts) == host(opts)


def sprite_png(seed, w, h):
    """test_composite_device.py's sprites: random RGBA, random alpha."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(seed).integers(0, 256, (h, w, 4), dtype=np.uint8),
                    "RGBA").save(buf, "PNG")
    return buf.getvalue()


def positioned_inputs():
    """tests/unit/test_composite_device.py:91-101: a 120 x 90 sprite and 8
    smaller ones at random places and z indices."""
    inputs = [{"source": sprite_png(0, 120, 90), "x": 0, "y": 0}]
    rng = np.random.default_rng(7)
    for i in range(8):
        inputs.append({
            "source": sprite_png(i + 1, int(rng.integers(15, 50)), int(rng.integers(15, 50))),
            "x": int(rng.integers(0, 90)),
            "y": int(rng.integers(0, 70)),
            "z_index": int(rng.integers(0, 4)),
        })
    return inputs


@pytest.mark.parametrize("fmt", ["png", "jpeg"])
def test_positioned_random_alpha_matches_jax_and_host(fmt):
    """Device compositing with exact-tie replays, then the encode."""
    opts = {"inputs": positioned_inputs(), "bandHeight": 32, "outputFormat": fmt}
    counters = image_stitch_tpu_torch.EncodeCounters()
    got = port(opts, counters=counters)
    assert got == host(opts, "jax") == host(opts)
    assert counters.composite_bands_on_device > 0 and counters.composite_fallback_bands > 0
    assert counters.composite_bands_on_device + counters.composite_fallback_bands == 4


def test_positioned_16bit_png_matches_host():
    """16-bit bands composite on the host, then filter in torch."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, 65536, (40, 50, 4), dtype=np.uint16)
    b = rng.integers(0, 65536, (20, 30, 4), dtype=np.uint16)
    opts = {"inputs": [PositionedImage(0, 0, png_from_array(a, bit_depth=16)),
                       PositionedImage(10, 12, png_from_array(b, bit_depth=16))],
            "outputFormat": "png", "bandHeight": 16}
    counters = image_stitch_tpu_torch.EncodeCounters()
    assert port(opts, counters=counters) == host(opts, "jax") == host(opts)
    assert counters.composite_bands_on_device == 0 and counters.png_bands == 3


@pytest.mark.parametrize("fmt", ["png", "jpeg"])
def test_positioned_without_blending_matches_host(fmt):
    """enableAlphaBlending false: sources overwrite, on the host."""
    opts = {"inputs": positioned_inputs(), "bandHeight": 32, "outputFormat": fmt,
            "enableAlphaBlending": False}
    counters = image_stitch_tpu_torch.EncodeCounters()
    assert port(opts, counters=counters) == host(opts)
    assert counters.composite_bands_on_device == counters.composite_fallback_bands == 0


@pytest.mark.parametrize("fmt", ["png", "jpeg"])
def test_positioned_stream_bands_are_host_arrays(fmt):
    """stream_bands hands out host arrays, bands blended on the device
    included, equal to the host tier's, whatever the output format."""
    from image_stitch_tpu.core import CoreStreamingConcatenator

    opts = {"inputs": positioned_inputs(), "bandHeight": 32, "outputFormat": fmt}
    counters = image_stitch_tpu_torch.EncodeCounters()
    got = list(image_stitch_tpu_torch.TorchStreamingConcatenator(
        opts, device="cpu", counters=counters).stream_bands())
    ref = list(CoreStreamingConcatenator({**opts, "backend": "numpy"}).stream_bands())
    assert all(type(b) is np.ndarray for b in got)
    assert len(got) == len(ref) == 4
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert counters.composite_bands_on_device > 0


@pytest.mark.parametrize("bad", [{"mesh": 64}, {"backend": "jax"}, {"backend": "tpu"}])
def test_other_paths_raise(bad):
    """A mesh of more shards than the CPU mesh has raises; the JAX
    package's device backends run the torch path, with its bytes."""
    opts = grid_options(64, 48, 0)
    if "backend" in bad:
        counters = image_stitch_tpu_torch.EncodeCounters()
        want = image_stitch_tpu.concat_to_buffer({**opts, "backend": "numpy"})
        assert port({**opts, **bad}, counters=counters) == port(opts) == want
        assert counters.bands > 0 and counters.host_tier_bands == 0
        return
    with pytest.raises(StitchError):
        port({**opts, **bad})


def test_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(StitchError, match="CUDA"):
        image_stitch_tpu_torch.concat_to_buffer(grid_options(64, 48, 0))


def test_slice_runs_without_jax():
    """The port imports no jax: a fresh process runs the JPEG slice and the
    PNG slice (grid, and positioned with device compositing) and checks
    sys.modules afterwards."""
    code = (
        "import sys, numpy as np\n"
        "import image_stitch_tpu_torch\n"
        "from image_stitch_tpu_torch.types import PositionedImage\n"
        "from tests.utils.fixtures import png_from_array\n"
        "img = np.full((32, 40, 4), 200, np.uint8)\n"
        "out = image_stitch_tpu_torch.concat_to_buffer({'inputs': [png_from_array(img)] * 2,"
        " 'layout': {'columns': 2}, 'outputFormat': 'jpeg',"
        " 'jpegRestartIntervalRows': 1}, device='cpu')\n"
        "assert out[:2] == b'\\xff\\xd8' and out[-2:] == b'\\xff\\xd9'\n"
        "out = image_stitch_tpu_torch.concat_to_buffer({'inputs': [png_from_array(img)] * 2,"
        " 'layout': {'columns': 2}, 'outputFormat': 'png'}, device='cpu')\n"
        "assert out[:8] == b'\\x89PNG\\r\\n\\x1a\\n' and out[-8:-4] == b'IEND'\n"
        "img[:, :, 3] = 90\n"
        "c = image_stitch_tpu_torch.EncodeCounters()\n"
        "out = image_stitch_tpu_torch.concat_to_buffer({'inputs': ["
        "PositionedImage(0, 0, png_from_array(img)), PositionedImage(5, 6, png_from_array(img))],"
        " 'outputFormat': 'png'}, device='cpu', counters=c)\n"
        "assert out[-8:-4] == b'IEND' and c.composite_bands_on_device == 1\n"
        "print('jax' in sys.modules)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "False"
