"""The port's JPEG-tile path against the benchmark's plain reference
(``stitchbench/reference``, NumPy alone), on the CPU.

Camera-style tiles, seeded photo-like content at small odd sizes, are made
by the reference's own encoder (q90, 4:2:0 and 4:4:4). The port's device
tier decode (``decode_tiles_band`` on a CPU band: the plain versions of
the two kernels) must give the reference reader's pixels exactly, and a
whole grid job through ``concat_streaming(..., device="cpu")`` the bytes of
the reference's JPEG of that canvas.
"""

import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import image_stitch_tpu_torch
from image_stitch_tpu_torch.codecs.jpeg.device_decoder import DeviceJpegDecoder, decode_tiles_band
from image_stitch_tpu_torch.ops.staging import BandStaging
from stitchbench.common.tiles import photo_rows
from stitchbench.kinds import grid
from stitchbench.reference import check, jpeg_decode
from stitchbench.reference import jpeg as ref_jpeg

ROOT = Path(__file__).resolve().parents[1]
SEED = (1 << 31) + 1717


class InProcess:
    """The harness's worker pool, run in this process: ``map`` calls
    ``module:function`` on each argument tuple."""

    def map(self, target: str, arg_list: list[tuple]) -> list:
        module, name = target.split(":")
        fn = getattr(importlib.import_module(module), name)
        return [fn(*args) for args in arg_list]


def camera_tile(tile: int, h: int, w: int, sampling: str) -> bytes:
    return ref_jpeg.encode(photo_rows(SEED, tile, h, w), 90, sampling)


@pytest.mark.parametrize("sampling", ["420", "444"])
@pytest.mark.parametrize("h,w", [(37, 29), (45, 67)])
def test_device_tier_decode_is_the_reference_reader(sampling, h, w):
    """A tile decoded whole, and in two bands that split it at an odd row,
    gives the reference's pixels exactly."""
    data = camera_tile(3, h, w, sampling)
    want = jpeg_decode.decode(data)
    dec = DeviceJpegDecoder(data)
    ring = BandStaging("cpu")
    for y0, y1 in ((0, h), (0, h // 2 + 1), (h // 2 + 1, h)):
        out = torch.zeros((y1 - y0, w, 4), dtype=torch.uint8)
        decode_tiles_band([(dec, y0, y1, 0)], out, ring)
        np.testing.assert_array_equal(out.numpy(), want[y0:y1])


def test_a_band_of_unlike_tiles_is_the_reference_reader():
    """Tiles of both samplings and two widths side by side in one band, each
    at its x offset: one staged band, the reference's pixels."""
    h = 29
    tiles = [camera_tile(t, h, w, s) for t, (w, s) in enumerate([(37, "420"), (24, "444"),
                                                                  (53, "420")])]
    want = np.concatenate([jpeg_decode.decode(d) for d in tiles], axis=1)
    items, x0 = [], 0
    for d in tiles:
        dec = DeviceJpegDecoder(d)
        items.append((dec, 3, h, x0))
        x0 += dec.width
    out = torch.zeros((h - 3, x0, 4), dtype=torch.uint8)
    decode_tiles_band(items, out, BandStaging("cpu"))
    np.testing.assert_array_equal(out.numpy(), want[3:])


@pytest.mark.parametrize("sampling", ["420", "444"])
def test_a_grid_job_is_the_references_jpeg(sampling):
    """A 3 x 2 grid job of the JPEG-tile mix's kind, cut to 33 x 27 tiles
    in 16-row bands (bands cross the tile rows), under the
    ``camera_jpeg_q85`` configuration's options: the reference's JPEG of
    the canvas, byte for byte, with every band decoded on the device
    tier."""
    pool = InProcess()
    params = json.loads((ROOT / "stitchbench" / "traffic" / "jpeg_tiles.json").read_text())
    params["tiles"].update(width=33, height=27, count=6, jpeg_sampling=sampling)
    params["grid"].update(columns=3, tiles_per_job=6)
    options = json.loads((ROOT / "stitchbench" / "configs" / "camera_jpeg_q85.json").read_text())
    options = dict(options["options"], bandHeight=16)
    job = grid.job(SEED, params, grid.make_state(SEED, params, pool), 5)
    counters = image_stitch_tpu_torch.EncodeCounters()
    got = b"".join(image_stitch_tpu_torch.concat_streaming(
        {**options, **job.options}, device="cpu", counters=counters))
    want = check.expected_jpeg(job.spec, options, pool)
    assert check.check_jpeg(got, want) == {"jpeg_bytes_differing": 0}
    assert got == want
    bands = job.spec.bands(16)
    assert counters.decode_bands_on_device == bands == 4
    assert counters.decode_tiles_opened == 6 and counters.host_tier_bands == 0
