"""The readers of the JPEG-tile device decode (``metrics/jpeg_decode.*``)
and the bytes it must move (``common/decode_work.py``): on synthetic
traces, each gives its value, and None without a profiled slice, without
the program's spans, or (the roofline) without either kernel; then on a
tiny job of the cell run on the CPU under the profiler."""

from __future__ import annotations

import json

import pytest

from conftest import ROOT, SEED, tiny_cell

CELL = "camera_jpeg_q85.jpeg_tiles"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
READERS = sorted(m["name"] for m in MANIFEST["per_layer"] if m["name"].startswith("jpeg_decode."))


def reader(name):
    from stitchbench.common.manifest import Metric

    return Metric(name, "", {}).reader()


class Job:
    def __init__(self, t_call, t_end, bands=16, spec=None, error=None):
        self.t_call, self.t_end, self.bands, self.spec, self.error = t_call, t_end, bands, spec, \
            error


class Trace:
    def __init__(self, jobs, profile=None, counters=None):
        self.jobs, self.profile, self.counters = jobs, profile, counters or {}


def spec_420():
    """One job of the mix's kind: 2 x 1 tiles of 32 x 24, 4:2:0."""
    from stitchbench.common.traffic import Traffic

    return Traffic("t", {"kind": "grid", "tiles": {"format": "jpeg", "width": 32, "height": 24,
                                                   "count": 2, "jpeg_quality": 90,
                                                   "jpeg_sampling": "420"},
                         "grid": {"columns": 2, "tiles_per_job": 2}}).job(SEED, None, 0).spec


def test_the_readers_are_the_manifests():
    assert READERS == [f"jpeg_decode.{m}" for m in (
        "busy_ms_per_band", "device_band_pct", "entropy_ms_per_band", "kernels_roofline",
        "stage_ms_per_band")]
    for m in MANIFEST["per_layer"]:
        if m["name"] in READERS:
            assert m["workloads"] == [CELL] and m["moves"] == "mp_per_s"
            assert m["layer"] == "JPEG-tile device decode"


def test_decode_bytes_count_coefficients_in_and_pixels_out():
    from stitchbench.common.decode_work import decode_bytes

    spec = spec_420()
    # each tile: 2 x 2 MCUs of 6 blocks, 64 coefficients of 2 bytes
    assert spec.input_bytes == 2 * 4 * 6 * 64 * 2
    assert decode_bytes(spec) == 2 * 4 * 6 * 128 + 24 * 64 * 4


def test_the_kernels_time_needs_both():
    from stitchbench.common.decode_work import kernel_seconds

    ops = [("void (anonymous namespace)::idct_dequant_batch_kernel(short const*, ...)", 0.002),
           ("Memcpy HtoD (Pinned -> Device)", 0.5),
           ("void (anonymous namespace)::ycc_rgba_batch_kernel<1>(...)", 0.003)]
    assert kernel_seconds(ops) == pytest.approx(0.005)
    assert kernel_seconds(ops[:2]) is None and kernel_seconds(ops[1:]) is None
    assert kernel_seconds([]) is None


def test_the_roofline_reads_the_profile_or_nothing():
    from stitchbench.common.decode_work import decode_bytes

    spec = spec_420()
    ops = [("idct_dequant_batch_kernel", 1e-9), ("fdct_quant_444_kernel<2>", 1.0),
           ("ycc_rgba_batch_kernel<1>", 3e-9)]
    jobs = [Job(0.0, 1.0, spec=spec), Job(1.0, 2.0, spec=spec), Job(2.0, 2.1, spec=spec,
                                                                    error="x")]
    t = Trace(jobs[:1], profile={"device_ops": ops, "jobs": jobs})
    want = 2 * decode_bytes(spec) / 3.35e12 / 4e-9 * 100
    assert reader("jpeg_decode.kernels_roofline")(t) == pytest.approx(want)
    assert reader("jpeg_decode.kernels_roofline")(Trace(jobs)) is None
    for missing in (ops[:2], ops[1:]):
        assert reader("jpeg_decode.kernels_roofline")(
            Trace(jobs, profile={"device_ops": missing, "jobs": jobs})) is None


def test_the_device_share_reads_the_window_counters():
    jobs = [Job(0.0, 1.0, bands=16), Job(1.0, 2.0, bands=16)]
    read = reader("jpeg_decode.device_band_pct")
    assert read(Trace(jobs, counters={"decode_bands_on_device": 32})) == 100.0
    assert read(Trace(jobs, counters={"decode_bands_on_device": 24})) == 75.0
    assert read(Trace(jobs, counters={})) is None
    assert read(Trace([], counters={"decode_bands_on_device": 0})) is None


def synthetic_spans(monkeypatch, records):
    from image_stitch_tpu_torch.utils import observability

    monkeypatch.setattr(observability, "spans", lambda: records)


def test_the_span_readers_per_band(monkeypatch):
    """Two jobs of 4 bands; spans in ms on the job's clock. A span outside
    the profiled jobs is not read."""
    from image_stitch_tpu_torch.utils.observability import Span

    ms = 1_000_000

    def s(name, a, b, i, parent, n=0):
        return Span(name, a * ms, b * ms, i, parent, 1, 0, n)

    records = [s("job", 0, 100, 1, None), s("decode.jpeg.open", 1, 11, 2, 1, 500),
               s("decode.jpeg.entropy", 2, 8, 3, 2, 500), s("decode.jpeg.band", 20, 30, 4, 1),
               s("decode.jpeg.stage", 21, 25, 5, 4, 9000), s("decode.jpeg.launch", 25, 29, 6, 4),
               s("job", 100, 200, 7, None), s("decode.jpeg.band", 120, 126, 8, 7),
               s("decode.jpeg.stage", 121, 123, 9, 8, 9000),
               s("decode.jpeg.band", 300, 390, 10, None)]
    synthetic_spans(monkeypatch, records)
    jobs = [Job(0.0, 0.1, bands=4), Job(0.1, 0.2, bands=4)]
    t = Trace(jobs, profile={"jobs": jobs})
    assert reader("jpeg_decode.busy_ms_per_band")(t) == pytest.approx((10 + 10 + 6) / 8)
    assert reader("jpeg_decode.entropy_ms_per_band")(t) == pytest.approx(6 / 8)
    assert reader("jpeg_decode.stage_ms_per_band")(t) == pytest.approx((4 + 2) / 8)
    for name in ("busy_ms_per_band", "entropy_ms_per_band", "stage_ms_per_band"):
        assert reader(f"jpeg_decode.{name}")(Trace(jobs)) is None
    synthetic_spans(monkeypatch, [r for r in records if not r.name.startswith("decode.jpeg")])
    for name in ("busy_ms_per_band", "entropy_ms_per_band", "stage_ms_per_band"):
        assert reader(f"jpeg_decode.{name}")(t) is None


@pytest.fixture(scope="module")
def tiny_traced(pool):
    """The cell cut to 160 x 136 tiles in 16-row bands, one job under the
    CPU profiler, with the window's counters of that job."""
    from torch.profiler import ProfilerActivity, profile

    from image_stitch_tpu_torch.ops.counters import EncodeCounters

    from stitchbench.common.traffic import PROFILE
    from stitchbench.run import load_port, run_job, streaming_program

    program = streaming_program(load_port(), "cpu")
    cell = tiny_cell(CELL, width=160, height=136)
    state = cell.traffic.make_state(SEED, pool)
    counters = EncodeCounters()
    with profile(activities=[ProfilerActivity.CPU]):
        job, _ = run_job(program, cell, cell.traffic.job(SEED, state, PROFILE), counters)
    assert job.error is None
    return cell, job, vars(counters).copy()


def test_the_readers_on_a_job_of_the_cell(tiny_traced):
    """Every band decoded on the device tier (a band crossing the two rows
    of tiles included); the span readers give positive numbers; with no
    device trace on the CPU, the roofline reads nothing."""
    from stitchbench.run import Trace as RunTrace

    cell, job, counters = tiny_traced
    t = RunTrace(cell, 1.0, [job], 1.0, 0, 0, counters, profile={"jobs": [job]})
    assert job.bands == 17 and counters["decode_bands_on_device"] == 17
    assert counters["decode_tiles_opened"] == 6 and counters["decode_staged_uploads"] == 18
    assert reader("jpeg_decode.device_band_pct")(t) == 100.0
    for name in ("busy_ms_per_band", "entropy_ms_per_band", "stage_ms_per_band"):
        assert reader(f"jpeg_decode.{name}")(t) > 0, name
    assert reader("jpeg_decode.busy_ms_per_band")(t) > reader("jpeg_decode.entropy_ms_per_band")(t)
    assert reader("jpeg_decode.kernels_roofline")(t) is None
