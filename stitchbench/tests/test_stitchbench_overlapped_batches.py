"""The reader of the PNG deflate's overlapped share
(``metrics/png_deflate.overlapped_batch_pct``): on synthetic counters, and
on a job of the PNG mosaic cell run on the CPU whose bands each fill a
deflate batch."""

from __future__ import annotations

import json

import pytest

from conftest import ROOT, SEED, tiny_cell

CELL = "png_l6.mosaic_10k"
NAME = "png_deflate.overlapped_batch_pct"


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
    assert entry["layer"] == "PNG encoder"
    assert entry["source"] == "program_counter" and entry["unit"] == "%"


@pytest.mark.parametrize("counters,want", [
    ({"deflate_batches": 40, "deflate_batches_overlapped": 39}, 97.5),
    ({"deflate_batches": 40, "deflate_batches_overlapped": 40}, 100.0),
    ({"deflate_batches": 1, "deflate_batches_overlapped": 0}, 0.0),
    ({"deflate_batches": 40}, None),  # a program without the counter
    ({"deflate_batches": 0, "deflate_batches_overlapped": 0}, None),
    ({}, None),
])
def test_the_share_of_batches(counters, want):
    got = reader()(Trace(counters))
    assert got == (pytest.approx(want) if want is not None else None)


def test_the_share_on_a_job_of_the_cell(pool):
    """A 528 x 1040 canvas of the cell in bands of 512 rows: each full
    band's filtered rows pass the 1 MB batch, so of three batches the two
    that more bands follow compress on the deflate worker."""
    from image_stitch_tpu_torch.ops.counters import EncodeCounters

    from stitchbench.run import Trace as RunTrace
    from stitchbench.run import load_port, run_job, streaming_program

    program = streaming_program(load_port(), "cpu")
    cell = tiny_cell(CELL, width=176, height=520)
    cell.config["options"]["bandHeight"] = 512
    state = cell.traffic.make_state(SEED, pool)
    counters = EncodeCounters()
    job, _ = run_job(program, cell, cell.traffic.job(SEED, state, 0), counters)
    assert job.error is None
    counters = vars(counters).copy()
    assert (counters["deflate_batches"], counters["deflate_batches_overlapped"]) == (3, 2)
    t = RunTrace(cell, 1.0, [job], 1.0, 0, 0, counters)
    assert reader()(t) == pytest.approx(200 / 3)
    del counters["deflate_batches_overlapped"]
    assert reader()(RunTrace(cell, 1.0, [job], 1.0, 0, 0, counters)) is None
