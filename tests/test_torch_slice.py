"""The torch port's grid/positioned -> JPEG slice, end to end.

``image_stitch_tpu_torch.concat_to_buffer(..., device="cpu")`` (the
kernels' plain versions) against ``image_stitch_tpu.concat_to_buffer`` with
``backend="jax"`` (JAX on the CPU) and ``backend="numpy"`` (the host tier):
the bytes must be equal. Mirrors tests/unit/test_jpeg_restart.py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import image_stitch_tpu
import image_stitch_tpu_torch
from image_stitch_tpu.errors import StitchError
from image_stitch_tpu.types import PositionedImage
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


def host(opts, backend="numpy"):
    return image_stitch_tpu.concat_to_buffer({**opts, "backend": backend})


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


def test_positioned_alpha_matches_host():
    """Positioned inputs with alpha over a background: compositing stays on
    the host, the encode runs in torch."""
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


def test_streaming_and_file_entry_points(tmp_path):
    opts = grid_options(64, 48, 0)
    whole = port(opts)
    assert b"".join(image_stitch_tpu_torch.concat_streaming(opts, device="cpu")) == whole
    path = tmp_path / "out.jpg"
    image_stitch_tpu_torch.concat_to_file(opts, path, device="cpu")
    assert path.read_bytes() == whole


def test_png_output_raises():
    opts = {**grid_options(64, 48, 0), "outputFormat": "png"}
    with pytest.raises(StitchError, match="ROADMAP"):
        port(opts)


@pytest.mark.parametrize("bad", [{"mesh": 2}, {"backend": "jax"}, {"backend": "numpy"}])
def test_other_paths_raise(bad):
    with pytest.raises(StitchError):
        port({**grid_options(64, 48, 0), **bad})


def test_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(StitchError, match="CUDA"):
        image_stitch_tpu_torch.concat_to_buffer(grid_options(64, 48, 0))


def test_slice_runs_without_jax():
    """The port imports no jax: a fresh process runs the slice and checks
    sys.modules afterwards."""
    code = (
        "import sys, numpy as np\n"
        "import image_stitch_tpu_torch\n"
        "from tests.utils.fixtures import png_from_array\n"
        "img = np.full((32, 40, 4), 200, np.uint8)\n"
        "out = image_stitch_tpu_torch.concat_to_buffer({'inputs': [png_from_array(img)] * 2,"
        " 'layout': {'columns': 2}, 'outputFormat': 'jpeg',"
        " 'jpegRestartIntervalRows': 1}, device='cpu')\n"
        "assert out[:2] == b'\\xff\\xd8' and out[-2:] == b'\\xff\\xd9'\n"
        "print('jax' in sys.modules)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "False"
