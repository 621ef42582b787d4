"""The readers of the program's own spans (``common/spans.py``): on a
``Trace`` whose profiled slice is a tiny job run on the CPU under
torch.profiler, each gives a positive number in its cells, None in the
other format's cell, and None without a profiled slice or without spans."""

from __future__ import annotations

import json

import pytest

from conftest import ROOT, SEED, tiny_cell

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
READERS = {m["name"]: m["workloads"] for m in MANIFEST["per_layer"]
           if m["name"].startswith(("decode_layout.", "jpeg_encode.", "png_encode."))
           and "added" not in m["name"] and m["name"] != "decode_layout.ms_per_band"}
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def reader(name):
    from stitchbench.common.manifest import Metric

    return Metric(name, "", {}).reader()


def trace_of(cell, records, profile=True):
    from stitchbench.run import Trace

    return Trace(cell, 1.0, records, 1.0, 0, 0, {},
                 profile={"jobs": records} if profile else None)


@pytest.fixture(scope="module")
def traces(pool):
    """Each cell cut to 160 x 136 tiles (above the small-tile group decode,
    so every tile streams through the inflater): one job under the
    profiler, and one without it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stitchbench.common.traffic import PROFILE
    from stitchbench.run import load_port, run_job, streaming_program

    program = streaming_program(load_port(), "cpu")
    out = {}
    for name in CELLS:
        cell = tiny_cell(name, width=160, height=136)
        state = cell.traffic.make_state(SEED, pool)
        with profile(activities=[ProfilerActivity.CPU]):
            traced, _ = run_job(program, cell, cell.traffic.job(SEED, state, PROFILE), None)
        assert not torch.autograd.profiler._is_profiler_enabled
        plain, _ = run_job(program, cell, cell.traffic.job(SEED, state, PROFILE + 1), None)
        assert traced.error is None and plain.error is None
        out[name] = (cell, traced, plain)
    return out


def test_the_readers_are_the_manifests():
    assert len(READERS) == 8
    assert all(set(cells) <= set(CELLS) for cells in READERS.values())


@pytest.mark.parametrize("name", sorted(READERS))
def test_each_reader_reads_its_cells_alone(traces, name):
    for cell_name, (cell, traced, plain) in traces.items():
        value = reader(name)(trace_of(cell, [traced]))
        if cell_name in READERS[name]:
            assert value is not None and value > 0, (name, cell_name)
        else:
            assert value is None, (name, cell_name)
        assert reader(name)(trace_of(cell, [traced], profile=False)) is None
        assert reader(name)(trace_of(cell, [plain])) is None


def test_the_numbers_add_up(traces):
    """Per band and in bytes, the readers agree with the recorder."""
    from image_stitch_tpu_torch.utils.observability import spans

    from stitchbench.common.spans import profiled_spans, top_level

    cell, traced, _ = traces["jpeg_q85.mosaic_10k"]
    t = trace_of(cell, [traced])
    records, bands = profiled_spans(t)
    assert bands == traced.bands and set(records) <= set(spans())
    (job,) = [r for r in records if r.name == "job"]
    assert traced.t_call * 1e9 <= job.start < job.end <= traced.t_end * 1e9
    top = top_level(records)
    assert {r.name for r in top} == {"assemble", "jpeg.submit", "jpeg.wait"}

    def ms(names):
        return sum(r.end - r.start for r in records if r.name in names) / 1e6 / bands

    assert reader("decode_layout.busy_ms_per_band")(t) == pytest.approx(ms({"assemble"}))
    assert reader("jpeg_encode.busy_ms_per_band")(t) == pytest.approx(
        ms({"jpeg.submit", "jpeg.wait"}) - ms({"jpeg.device_wait"}))
    h, w = cell.traffic.job(SEED, None, 0).spec.canvas
    up = [r for r in records if r.name == "jpeg.upload"]
    assert sum(r.n for r in up) == h * w * 3
    assert reader("jpeg_encode.upload_gb_per_s")(t) == pytest.approx(
        h * w * 3 / sum(r.end - r.start for r in up))
