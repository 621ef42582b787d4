"""The reader of the JPEG-tile decode's native-prefix share
(``metrics/jpeg_tiles.native_prefix_pct``): on synthetic counters, and on
a tiny job of the JPEG-tile cell run on the CPU."""

from __future__ import annotations

import json

import pytest

from conftest import ROOT, SEED, tiny_cell

CELL = "camera_jpeg_q85.jpeg_tiles"
NAME = "jpeg_tiles.native_prefix_pct"


def reader():
    from stitchbench.common.manifest import Metric

    return Metric(NAME, "", {}).reader()


class Trace:
    def __init__(self, counters):
        self.jobs, self.profile, self.counters = [], None, counters


def test_the_manifest_entry():
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(m for m in manifest["per_layer"] if m["name"] == NAME)
    assert entry["workloads"] == [CELL] and entry["moves"] == "mp_per_s"
    assert entry["layer"] == "JPEG-tile device decode"
    assert entry["source"] == "program_counter" and entry["unit"] == "%"


@pytest.mark.parametrize("counters,want", [
    ({"decode_tiles_opened": 16, "decode_tiles_native_prefix": 16}, 100.0),
    ({"decode_tiles_opened": 16, "decode_tiles_native_prefix": 12}, 75.0),
    ({"decode_tiles_opened": 16}, None),  # a program without the counter
    ({"decode_tiles_opened": 0, "decode_tiles_native_prefix": 0}, None),
    ({}, None),
])
def test_the_share_of_tiles(counters, want):
    got = reader()(Trace(counters))
    assert got == (pytest.approx(want) if want is not None else None)


def test_the_share_on_a_job_of_the_cell(pool):
    """Every tile of a tiny job of the cell opened by the device tier takes
    the native scan's transport."""
    from image_stitch_tpu_torch.ops.counters import EncodeCounters

    from stitchbench.run import Trace as RunTrace
    from stitchbench.run import load_port, run_job, streaming_program

    program = streaming_program(load_port(), "cpu")
    cell = tiny_cell(CELL, width=64, height=48)
    state = cell.traffic.make_state(SEED, pool)
    counters = EncodeCounters()
    job, _ = run_job(program, cell, cell.traffic.job(SEED, state, 0), counters)
    assert job.error is None
    counters = vars(counters).copy()
    assert counters["decode_tiles_opened"] == 6
    t = RunTrace(cell, 1.0, [job], 1.0, 0, 0, counters)
    assert reader()(t) == 100.0
    del counters["decode_tiles_native_prefix"]
    assert reader()(RunTrace(cell, 1.0, [job], 1.0, 0, 0, counters)) is None
