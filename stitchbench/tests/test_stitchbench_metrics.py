"""The metric arithmetic on synthetic data."""

from __future__ import annotations

import pytest

from conftest import ROOT


def reader(name):
    from stitchbench.common.manifest import Metric

    return Metric(name, "", {}).reader()


class Job:
    def __init__(self, t_call, t_first, t_end, mp=100.0, bands=40, error=None):
        self.t_call, self.t_first, self.t_end = t_call, t_first, t_end
        self.megapixels, self.bands, self.error, self.out_bytes = mp, bands, error, 0


class Trace:
    def __init__(self, jobs, window_s=1.0, options=None, profile=None, layer_pairs=None):
        self.jobs, self.window_s, self.profile, self.layer_pairs = jobs, window_s, profile, \
            layer_pairs
        self.setup_s, self.rss_peak_bytes, self.device_peak_bytes = 12.5, 2_000_000_000, 70_000_000
        self.cell = type("C", (), {"options": options or {"outputFormat": "jpeg"}})()


def test_union_and_gaps_of_device_intervals():
    from stitchbench.common.work import gaps, union_seconds

    spans = [(1.0, 2.0), (1.5, 3.0), (5.0, 6.0), (-1.0, 0.5), (9.0, 12.0)]
    assert union_seconds(spans, 0.0, 10.0) == pytest.approx(0.5 + 2.0 + 1.0 + 1.0)
    assert gaps(spans, 0.0, 10.0) == [(0.5, 1.0), (3.0, 5.0), (6.0, 9.0)]
    assert gaps([], 0.0, 2.0) == [(0.0, 2.0)]


def test_device_bytes_count_each_input_and_output_once():
    from stitchbench.common.traffic import Traffic
    from stitchbench.common.work import bound_ms, device_bytes
    from stitchbench.kinds.grid import jpeg_blocks

    def spec(fmt, **kw):
        return Traffic("t", {"kind": "grid", "tiles": dict(format=fmt, width=10, height=8,
                                                           count=1, **kw),
                             "grid": {"columns": 1, "tiles_per_job": 1}}).job(1, None, 0).spec

    mosaic = Traffic("m", {"kind": "grid", "tiles": {"format": "png", "width": 1000,
                                                     "height": 1000, "count": 100},
                           "grid": {"columns": 10, "tiles_per_job": 100}}).job(1, None, 0).spec
    assert device_bytes({"outputFormat": "jpeg"}, mosaic, 25_000_000) == 425_000_000
    assert device_bytes({"outputFormat": "png"}, spec("png"), 123) == 8 * 10 * 4 + 8 * 41
    assert jpeg_blocks(1024, 1024, "420") == 16384 + 2 * 4096
    assert jpeg_blocks(8, 10, "444") == 3 * 2 and jpeg_blocks(8, 10, "420") == 6
    tiles = spec("jpeg", jpeg_sampling="420")
    assert device_bytes({"outputFormat": "jpeg"}, tiles, 7) == 6 * 128 + 7
    assert bound_ms(3_350_000_000) == pytest.approx(1.0)


def test_rates_and_per_band_readers():
    jobs = [Job(0.0, 0.01, 4.0), Job(4.1, 4.12, 8.0), Job(8.1, 8.1, 8.2, error="x")]
    pairs = [{"whole_s": 4.0, "whole_bands": 40, "decode_s": 2.4, "decode_bands": 40},
             {"whole_s": 3.0, "whole_bands": 40, "decode_s": 2.0, "decode_bands": 40},
             {"whole_s": None, "whole_bands": None, "decode_s": 2.2, "decode_bands": 40}]
    t = Trace(jobs, window_s=8.0, layer_pairs=pairs)
    assert reader("mp_per_s")(t) == pytest.approx(200.0 / 8.0)
    assert reader("decode_layout.ms_per_band")(t) == pytest.approx(6.6 / 120 * 1e3)
    assert reader("jpeg_encode.added_ms_per_band")(t) == pytest.approx((40.0 + 25.0) / 2)
    assert reader("png_encode.added_ms_per_band")(t) is None
    assert reader("jpeg_encode.added_ms_per_band")(Trace(jobs)) is None
    assert reader("decode_layout.ms_per_band")(Trace(jobs)) is None
    assert reader("setup_s")(t) == 12.5
    assert reader("peak_host_mb")(t) == 2000.0 and reader("peak_device_mb")(t) == 70.0


def test_device_readers_read_the_profile_or_nothing():
    prof = {"wall_s": 4.0, "busy_s": 0.02, "kernel_s": 0.01, "activities": 9,
            "device_bytes": 3.35e12 * 0.001}
    t = Trace([], profile=prof)
    assert reader("device.idle_pct")(t) == pytest.approx(99.5)
    assert reader("kernels_roofline")(t) == pytest.approx(10.0)
    empty = Trace([], profile=dict(prof, kernel_s=0.0, activities=0))
    assert reader("kernels_roofline")(empty) is None
    assert reader("device.idle_pct")(empty) is None
    assert reader("device.idle_pct")(Trace([])) is None


def test_every_reader_file_is_named_in_the_manifest():
    import json

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    named = {m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]}
    files = {p.name[:-3] for p in (ROOT / "stitchbench" / "metrics").glob("*.py")}
    assert files == named
