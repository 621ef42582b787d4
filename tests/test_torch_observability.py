"""The torch port's ``device_trace`` (torch.profiler), mirroring
tests/unit/test_observability.py: a no-op without a directory; with one, a
Chrome trace of the region that names the port's functions. On the CPU the
trace holds Python stacks and host ops; on a card it also holds the kernels
(chip_smoke.py checks ``fdct_quant`` and ``pack_merge`` there)."""

import json

import numpy as np
import pytest
import torch

import image_stitch_tpu_torch as port
from image_stitch_tpu_torch.utils.observability import device_trace
from tests.utils.fixtures import png_from_array, random_rgba

torch.set_num_threads(1)


def trace_names(log_dir) -> set[str]:
    """The event names of the one trace file in ``log_dir``."""
    files = list(log_dir.glob("*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return {e.get("name", "") for e in json.load(f)["traceEvents"]}


def small_grid(fmt="jpeg"):
    tiles = [png_from_array(random_rgba(24, 16, s)) for s in range(4)]
    return {"inputs": tiles, "layout": {"columns": 2}, "outputFormat": fmt,
            "jpegRestartIntervalRows": 1}


def test_device_trace_noop_without_dir(monkeypatch, tmp_path):
    monkeypatch.delenv("STITCH_TPU_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with device_trace():
        x = 1 + 1
    assert x == 2
    assert not torch.autograd.profiler._is_profiler_enabled
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_device_trace_names_the_ports_functions(monkeypatch, tmp_path, how):
    """A small grid to JPEG on the CPU under the trace: the encoder's
    quantize and pack wrappers appear, by name, with their module."""
    if how == "environment":
        monkeypatch.setenv("STITCH_TPU_TRACE_DIR", str(tmp_path))
        region = device_trace()
    else:
        monkeypatch.delenv("STITCH_TPU_TRACE_DIR", raising=False)
        region = device_trace(tmp_path)
    with region:
        out = port.concat_to_buffer(small_grid(), device="cpu")
    assert out[:2] == b"\xff\xd8"
    names = trace_names(tmp_path)
    for fn in ("fdct_quant", "pack_merge"):
        assert any(n.startswith("image_stitch_tpu_torch/ops/kernels.py(") and n.endswith(
            f"): {fn}") for n in names), fn


def test_device_trace_of_the_host_tier(tmp_path):
    """The host tier under the trace: its encoder appears and no kernel
    wrapper does."""
    with device_trace(tmp_path):
        out = port.concat_to_buffer({**small_grid(), "backend": "numpy"})
    assert out[:2] == b"\xff\xd8"
    names = trace_names(tmp_path)
    assert any(n.endswith("): encode_band") and "codecs/jpeg/encoder.py" in n for n in names)
    assert not any("ops/kernels.py" in n for n in names)


def test_device_trace_writes_on_error(tmp_path):
    """A region that raises still leaves its trace, and the error passes."""
    with pytest.raises(ValueError):
        with device_trace(tmp_path):
            np.zeros(3).sum()
            raise ValueError("inside the region")
    assert trace_names(tmp_path)


# --------------------------------------------------------------------------- #
# Spans: one recorder, on only while a profiler records
# --------------------------------------------------------------------------- #

import itertools  # noqa: E402
import tracemalloc  # noqa: E402

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from image_stitch_tpu_torch.core import TorchStreamingConcatenator  # noqa: E402
from image_stitch_tpu_torch.utils import observability as ob  # noqa: E402
from tests.utils.fixtures import png_from_array  # noqa: E402

# Each span's parent on the job's thread, by name.
PARENTS = {
    "assemble": "job", "decode.png": "assemble", "decode.inflate": "decode.png",
    "decode.defilter": "decode.png",
    "jpeg.submit": "job", "jpeg.upload": "jpeg.submit", "jpeg.upload.copy": "jpeg.upload",
    "jpeg.wait": "job", "jpeg.device_wait": "jpeg.wait",
    "jpeg.stuff": "jpeg.wait",
    "png.submit": "job", "png.upload": "png.submit", "png.device_wait": "job",
    "png.deflate": "job", "png.idat": "job",
    # the final batch compresses on the job's thread; one on the deflate
    # worker has no parent (test_deflate_batches_on_the_worker)
    "png.deflate.batch": "png.deflate",
    "decode.jpeg.open": "job", "decode.jpeg.entropy": "decode.jpeg.open",
    "decode.jpeg.band": "job", "decode.jpeg.stage": "decode.jpeg.band",
    "decode.jpeg.launch": "decode.jpeg.band",
}
DECODE = {"job", "assemble", "decode.png", "decode.inflate", "decode.defilter"}
CATALOGUE = {"jpeg": DECODE | {n for n in PARENTS if n.startswith("jpeg.")},
             "png": DECODE | {n for n in PARENTS if n.startswith("png.")}}


def smooth_tile(seed: int, w: int = 160, h: int = 120) -> bytes:
    """A tile too large for the small-tile group decode (so each tile
    streams through the inflater) and smooth enough that every JPEG band
    packs on the device path."""
    y, x = np.mgrid[0:h, 0:w]
    arr = np.empty((h, w, 4), np.uint8)
    arr[..., 0] = (x * 255 // w + seed * 40) % 256
    arr[..., 1] = (y * 255 // h + seed * 70) % 256
    arr[..., 2] = (x + y) // 2 % 256
    arr[..., 3] = 255
    return png_from_array(arr)


def grid_options(fmt: str, **extra) -> dict:
    """A 2x2 grid of 160x120 tiles in 64-row bands: the cells' path (JPEG
    without restart markers, PNG at level 6) at a tiny size."""
    return {"inputs": [smooth_tile(s) for s in range(4)], "layout": {"columns": 2},
            "outputFormat": fmt, "bandHeight": 64, **extra}


def profiled_jobs(*concatenators, interleave=False):
    """Run each concatenator's stream() under a CPU profiler, one after
    another or (``interleave``) a chunk of each in turn on this thread;
    returns the outputs."""
    with profile(activities=[ProfilerActivity.CPU]):
        gens = [c.stream() for c in concatenators]
        outs = [[] for _ in gens]
        if interleave:
            for pair in itertools.zip_longest(*gens):
                for out, chunk in zip(outs, pair):
                    if chunk is not None:
                        out.append(chunk)
        else:
            for out, gen in zip(outs, gens):
                out.extend(gen)
    return [b"".join(o) for o in outs]


def test_spans_off_record_nothing_and_allocate_nothing():
    """Untraced, a span site hands back one shared object and keeps
    nothing; a whole job records no span and reports no stages."""
    assert not torch.autograd.profiler._is_profiler_enabled
    ob.clear()
    assert ob.span("a") is ob.span("b", 7) is ob._OFF

    def sites(k):
        for _ in itertools.repeat(None, k):
            with ob.span("decode.inflate", 12345) as s:
                s.n = 99999

    sites(10)
    tracemalloc.start()
    try:
        tracemalloc.reset_peak()
        before = tracemalloc.get_traced_memory()[0]
        sites(20000)
        now, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert now == before and peak - before < 1024
    c = TorchStreamingConcatenator(grid_options("jpeg"), device="cpu")
    out = b"".join(c.stream())
    assert out[:2] == b"\xff\xd8"
    assert ob.spans() == [] and ob.RECORDER.dropped == 0
    assert c.stats.job is None and c.stats.report()["stages"] == {}
    assert c.stats.report()["bands"] == 4 and c.stats.report()["output_bytes"] == len(out)


@pytest.mark.parametrize("fmt", ["jpeg", "png"])
def test_spans_under_the_profiler(fmt):
    """A 2x2 grid on the CPU under torch.profiler records every span of its
    format's catalogue, each under its parent and inside it, one job id,
    and self times that are durations less the children's; the bytes are
    those of the untraced run."""
    ob.clear()
    plain = b"".join(TorchStreamingConcatenator(grid_options(fmt), device="cpu").stream())
    c = TorchStreamingConcatenator(grid_options(fmt), device="cpu")
    (out,) = profiled_jobs(c)
    assert out == plain
    recs = ob.spans()
    assert {r.name for r in recs} == CATALOGUE[fmt]
    assert {r.job for r in recs} == {c.stats.job}
    by_id = {r.id: r for r in recs}
    (job,) = [r for r in recs if r.name == "job"]
    assert job.parent is None and job.n == len(out)
    for r in recs:
        if r.name == "job":
            continue
        parent = by_id[r.parent]
        assert parent.name == PARENTS[r.name], (r.name, parent.name)
        assert parent.start <= r.start <= r.end <= parent.end
    for name in ("decode.inflate", "jpeg.upload", "jpeg.stuff", "jpeg.device_wait",
                 "png.upload", "png.idat"):
        assert all(r.n > 0 for r in recs if r.name == name), name
    # push() counts its bytes in; finish() has none to count
    assert [r.n > 0 for r in recs if r.name == "png.deflate"] in ([], [True] * 4 + [False])
    assert sum(r.n for r in recs if r.name == "decode.inflate") == 4 * 120 * (1 + 160 * 4)
    if fmt == "jpeg":
        assert sum(r.n for r in recs if r.name == "jpeg.upload") == 240 * 320 * 3
    children = {r.id: sum(k.end - k.start for k in recs if k.parent == r.id) for r in recs}
    want: dict = {}
    for r in recs:
        want[r.name] = want.get(r.name, 0) + (r.end - r.start - children[r.id]) / 1e9
    got = ob.self_seconds(recs)
    assert got.keys() == want.keys()
    assert all(got[k] == pytest.approx(want[k], abs=1e-9) for k in want)
    assert all(v >= 0 for v in got.values())
    stages = c.stats.report()["stages"]
    assert stages.keys() == want.keys()
    assert all(stages[k] == pytest.approx(want[k], abs=1e-6) for k in want)
    assert sum(stages.values()) == pytest.approx((job.end - job.start) / 1e9, abs=1e-5)


def test_interleaved_jobs_keep_their_ids():
    """Two stream() generators advanced in turns on one thread: each span
    carries the id of the job whose code opened it."""
    ob.clear()
    a = TorchStreamingConcatenator(grid_options("jpeg"), device="cpu")
    b = TorchStreamingConcatenator(grid_options("png"), device="cpu")
    out_a, out_b = profiled_jobs(a, b, interleave=True)
    assert out_a[:2] == b"\xff\xd8" and out_b[:4] == b"\x89PNG"
    recs = ob.spans()
    assert a.stats.job != b.stats.job
    assert {r.job for r in recs} == {a.stats.job, b.stats.job}
    for r in recs:
        owner = {"jpeg": a.stats.job, "png": b.stats.job}.get(r.name.split(".")[0])
        if owner is not None:
            assert r.job == owner, r
    by_id = {r.id: r for r in recs}
    assert all(by_id[r.parent].job == r.job for r in recs if r.parent is not None)
    for c, fmt in ((a, "jpeg"), (b, "png")):
        assert {r.name for r in recs if r.job == c.stats.job} == CATALOGUE[fmt]
    solo = b"".join(TorchStreamingConcatenator(grid_options("png"), device="cpu").stream())
    assert out_b == solo


def test_pool_tasks_carry_the_job():
    """With host threads, a tile pull runs on a pool thread and its spans
    carry the submitting job's id; there is no open span on that thread, so
    the pull has no parent."""
    ob.clear()
    c = TorchStreamingConcatenator(grid_options("png", hostThreads=2), device="cpu")
    (out,) = profiled_jobs(c)
    assert out[:4] == b"\x89PNG"
    recs = ob.spans()
    assert {r.job for r in recs} == {c.stats.job}
    (job,) = [r for r in recs if r.name == "job"]
    pulls = [r for r in recs if r.name == "decode.png"]
    away = [r for r in pulls if r.thread != job.thread]
    assert away and all(r.parent is None for r in away)


def test_deflate_batches_on_the_worker():
    """A traced PNG job of three deflate batches at host threads 1 (a
    512 x 1040 canvas in bands of 512 rows, each band's filtered rows past
    the 1 MB batch): the first two ``png.deflate.batch`` spans on the
    deflate worker's thread, without a parent, carrying the job's id; the
    final one under ``png.deflate`` on the job's thread; one
    ``png.deflate.wait`` under ``png.deflate`` for each batch in flight when
    the next was submitted. The batches' ``n`` add up to the filtered rows,
    and the bytes are the untraced run's."""
    opts = {"inputs": [smooth_tile(s, w=256, h=520) for s in range(4)],
            "layout": {"columns": 2}, "outputFormat": "png", "bandHeight": 512,
            "hostThreads": 1}
    ob.clear()
    plain = b"".join(TorchStreamingConcatenator(opts, device="cpu").stream())
    c = TorchStreamingConcatenator(opts, device="cpu")
    (out,) = profiled_jobs(c)
    c.close()
    assert out == plain
    recs = ob.spans()
    by_id = {r.id: r for r in recs}
    (job,) = [r for r in recs if r.name == "job"]
    batches = [r for r in recs if r.name == "png.deflate.batch"]
    assert len(batches) == 3 and {r.job for r in batches} == {c.stats.job}
    assert sum(r.n for r in batches) == 1040 * (1 + 512 * 4)
    away = [r for r in batches if r.thread != job.thread]
    assert len(away) == 2 and all(r.parent is None for r in away)
    (last,) = [r for r in batches if r.thread == job.thread]
    assert by_id[last.parent].name == "png.deflate" and last.n == 16 * (1 + 512 * 4)
    waits = [r for r in recs if r.name == "png.deflate.wait"]
    assert len(waits) == 2 and all(by_id[r.parent].name == "png.deflate" for r in waits)
    assert (c.counters.deflate_batches, c.counters.deflate_batches_overlapped) == (3, 2)


def test_the_cap_counts_dropped(monkeypatch):
    """Past the cap a span is counted, not kept."""
    r = ob.Recorder(cap=3)
    for i in range(5):
        r.add(ob.Span("x", i, i + 1, i, None, 1, 0, 0))
    assert len(r.spans()) == 3 and r.dropped == 2
    r.clear()
    assert r.spans() == [] and r.dropped == 0
    ob.clear()
    monkeypatch.setattr(ob.RECORDER, "cap", 5)
    profiled_jobs(TorchStreamingConcatenator(grid_options("png"), device="cpu"))
    assert len(ob.spans()) == 5 and ob.RECORDER.dropped > 0
    ob.clear()


@pytest.mark.parametrize("fmt,fast", [("jpeg", True), ("png", True), ("jpeg", False)])
def test_device_trace_holds_the_span_names(monkeypatch, tmp_path, fmt, fast):
    """The Chrome trace that device_trace writes shows each span of the
    job as a range, beside the port's functions: through torch's fast
    RecordFunction, or record_function where torch has none."""
    if not fast:
        monkeypatch.delattr(torch._C._profiler, "_RecordFunctionFast")
    with device_trace(tmp_path):
        out = port.concat_to_buffer(grid_options(fmt), device="cpu")
    assert out
    assert CATALOGUE[fmt] - {"job"} <= trace_names(tmp_path)


# --------------------------------------------------------------------------- #
# The JPEG-tile device decode
# --------------------------------------------------------------------------- #

JPEG_TILE_DECODE = {n for n in PARENTS if n.startswith("decode.jpeg.")}


def jpeg_tile_options() -> dict:
    """A 2x2 grid of 160x120 q90 4:2:0 JPEG tiles in 64-row bands: every
    band decoded by the device tier (on the CPU, the kernels' plain
    versions), the band of rows 64-128 across both rows of tiles."""
    tiles = [port.concat_to_buffer({"inputs": [smooth_tile(s)], "layout": {"columns": 1},
                                    "outputFormat": "jpeg", "jpegQuality": 90,
                                    "jpegSampling": "420"}, device="cpu") for s in range(4)]
    return {"inputs": tiles, "layout": {"columns": 2}, "outputFormat": "jpeg",
            "bandHeight": 64}


def test_jpeg_tile_decode_spans_under_the_profiler():
    """A traced job over JPEG tiles records each span of the decode under
    its parent, with its ``n``: each tile opened once (its file's bytes,
    the host Huffman decode under it), a band span a band, a staged upload
    and a launch pair for each row of tiles a band crosses. The counters
    count the tiles opened and the decode ring's uploads, as untraced."""
    opts = jpeg_tile_options()
    ob.clear()
    plain_counters = port.EncodeCounters()
    plain = b"".join(TorchStreamingConcatenator(opts, device="cpu",
                                                counters=plain_counters).stream())
    assert ob.spans() == []
    counters = port.EncodeCounters()
    c = TorchStreamingConcatenator(opts, device="cpu", counters=counters)
    (out,) = profiled_jobs(c)
    assert out == plain and counters == plain_counters
    recs = ob.spans()
    assert JPEG_TILE_DECODE <= {r.name for r in recs}
    assert not {"assemble", "decode.png", "decode.jpeg", "jpeg.upload"} & {r.name for r in recs}
    by_id = {r.id: r for r in recs}
    for r in recs:
        if r.name in JPEG_TILE_DECODE:
            parent = by_id[r.parent]
            assert parent.name == PARENTS[r.name], (r.name, parent.name)
            assert parent.start <= r.start <= r.end <= parent.end
    names = [r.name for r in recs]
    sizes = sorted(len(t) for t in opts["inputs"])
    assert sorted(r.n for r in recs if r.name == "decode.jpeg.open") == sizes
    assert sorted(r.n for r in recs if r.name == "decode.jpeg.entropy") == sizes
    assert names.count("decode.jpeg.band") == 4
    assert names.count("decode.jpeg.stage") == names.count("decode.jpeg.launch") == 5
    # at least one luma block row of both tiles: 40 blocks, K >= 8, 2 B each
    assert all(r.n >= 40 * 8 * 2 for r in recs if r.name == "decode.jpeg.stage")
    assert all(r.n == 0 for r in recs if r.name in ("decode.jpeg.band", "decode.jpeg.launch"))
    assert (counters.decode_bands_on_device, counters.decode_tile_bands) == (4, 10)
    assert counters.decode_tiles_opened == 4 and counters.decode_staged_uploads == 5
    assert counters.decode_staging_stalls == 0 and counters.host_tier_bands == 0


def test_jpeg_tile_decode_untraced_records_nothing():
    ob.clear()
    c = TorchStreamingConcatenator(jpeg_tile_options(), device="cpu")
    assert b"".join(c.stream())[:2] == b"\xff\xd8"
    assert ob.spans() == [] and c.stats.report()["stages"] == {}
    assert c.counters.decode_tiles_opened == 4 and c.counters.decode_staged_uploads == 5
