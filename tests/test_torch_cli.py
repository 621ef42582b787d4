"""The torch port's command line beside the JAX package's.

``image_stitch_tpu_torch.__main__.main([... "--device", "cpu"])`` against
``image_stitch_tpu.__main__.main`` on the same files: the cases of
tests/unit/test_cli.py, with the output files equal byte for byte (the JAX
package's CLI leaves the backend to its auto policy, which takes the host
tier for these small canvases; the port's CPU path gives its bytes). Then
what the port's CLI adds: ``--device``; ``--mesh`` over virtual CPU shards,
with the JAX CLI's ``--mesh`` bytes, and refused past the shards there are.
"""

import numpy as np
import pytest
import torch

from image_stitch_tpu.__main__ import main as jax_main
from image_stitch_tpu_torch.__main__ import build_parser, main
from tests.utils.fixtures import decode_png_pil, png_from_array, random_rgba

torch.set_num_threads(1)


@pytest.fixture()
def tile_files(tmp_path):
    paths = []
    for i in range(4):
        p = tmp_path / f"tile{i}.png"
        p.write_bytes(png_from_array(random_rgba(48, 40, seed=i)))
        paths.append(str(p))
    return paths


def both(args: list[str], tmp_path, name: str) -> tuple[bytes, bytes]:
    """The port's CLI on the CPU and the JAX package's CLI on ``args``, each
    into its own file: (the port's bytes, the JAX package's)."""
    ours, theirs = tmp_path / f"port_{name}", tmp_path / f"jax_{name}"
    assert main([*args, "-o", str(ours), "--quiet", "--device", "cpu"]) == 0
    assert jax_main([*args, "-o", str(theirs), "--quiet"]) == 0
    return ours.read_bytes(), theirs.read_bytes()


def test_cli_grid_png(tile_files, tmp_path):
    got, want = both([*tile_files, "--columns", "2"], tmp_path, "out.png")
    assert got == want
    arr = decode_png_pil(got)
    assert arr.shape == (80, 96, 4)
    np.testing.assert_array_equal(arr[:40, :48], random_rgba(48, 40, seed=0))


def test_cli_jpeg_by_extension(tile_files, tmp_path):
    got, want = both([*tile_files, "--columns", "4", "--quality", "95"], tmp_path, "out.jpg")
    assert got == want
    assert got[:2] == b"\xff\xd8" and got[-2:] == b"\xff\xd9"


@pytest.mark.parametrize("extra", [["--format", "jpeg", "--sampling", "420"],
                                   ["--rows", "2", "--band-height", "16"],
                                   ["--format", "png", "--level", "1"]],
                         ids=["jpeg420", "rows", "level"])
def test_cli_flags_carry_over(tile_files, tmp_path, extra):
    got, want = both([*tile_files, *extra], tmp_path, "out.bin")
    assert got == want


def test_cli_positioned(tile_files, tmp_path):
    got, want = both([tile_files[0], tile_files[1], "--positioned", "--at", "0,0",
                      "--at", "20,10"], tmp_path, "pos.png")
    assert got == want
    assert decode_png_pil(got).shape == (50, 68, 4)


def test_cli_positioned_missing_at(tile_files, tmp_path, capsys):
    rc = main([tile_files[0], tile_files[1], "--positioned", "--at", "0,0",
               "-o", str(tmp_path / "x.png"), "--quiet", "--device", "cpu"])
    assert rc == 2
    assert "--at" in capsys.readouterr().err
    rc = main([tile_files[0], "--positioned", "--at", "zero", "-o", str(tmp_path / "x.png"),
               "--quiet", "--device", "cpu"])
    assert rc == 2


def test_cli_decode_error_is_clean(tmp_path, capsys):
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"\x89PNG\r\n\x1a\n" + b"garbage" * 10)
    rc = main([str(bad), "-o", str(tmp_path / "o.png"), "--quiet", "--device", "cpu"])
    assert rc == 1
    assert "error:" in capsys.readouterr().err


def test_cli_threads_and_background(tile_files, tmp_path):
    got, want = both([tile_files[0], tile_files[1], tile_files[2], "--columns", "2",
                      "--threads", "3", "--background", "10,20,30,255"], tmp_path, "bg.png")
    assert got == want
    # bottom-right cell is background
    np.testing.assert_array_equal(decode_png_pil(got)[79, 95], [10, 20, 30, 255])


def test_cli_progress_goes_to_stderr(tile_files, tmp_path, capsys):
    assert main([*tile_files, "--columns", "2", "-o", str(tmp_path / "p.png"),
                 "--device", "cpu"]) == 0
    captured = capsys.readouterr()
    assert "4/4 inputs" in captured.err and captured.out == ""


def test_cli_mesh_is_refused_cleanly(tile_files, tmp_path, capsys):
    """``--mesh 2 --device cpu`` writes the JAX CLI's ``--mesh 2`` file;
    ``--mesh 64`` exits 1 with an error that names the devices, before the
    file is opened."""
    for name in ("m.png", "m.jpg"):
        got, want = both([*tile_files, "--columns", "2", "--mesh", "2"], tmp_path, name)
        assert got == want
    rc = main([*tile_files, "--columns", "2", "-o", str(tmp_path / "m64.png"), "--quiet",
               "--mesh", "64", "--device", "cpu"])
    assert rc == 1
    err = capsys.readouterr().err
    assert err.startswith("error: mesh requests 64 devices") and "devices" in err
    assert not (tmp_path / "m64.png").exists()


def test_cli_device_cuda_without_a_card_exits_1(tile_files, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("checks the error without a GPU")
    for extra in ([], ["--device", "cuda"]):  # cuda is the default
        rc = main([*tile_files, "--columns", "2", "-o", str(tmp_path / "c.png"), "--quiet",
                   *extra])
        assert rc == 1
        assert "CUDA is not available" in capsys.readouterr().err
        assert not (tmp_path / "c.png").exists()  # refused before the file was opened


def test_cli_parser_has_the_jax_package_flags_and_device():
    from image_stitch_tpu.__main__ import build_parser as jax_parser

    def flags(parser):
        return {s for a in parser._actions for s in a.option_strings}

    ours = build_parser()
    assert flags(ours) - flags(jax_parser()) == {"--device"}
    assert flags(jax_parser()) <= flags(ours)
    assert ours.prog == "image_stitch_tpu_torch"
    assert ours.parse_args(["a.png", "-o", "o.png"]).device == "cuda"
