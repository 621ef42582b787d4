"""run.py end to end: refused without a card or without the port; on the
CPU at a tiny size, every cell's whole run (set-up, window, decode pass,
check) comes out correct, and comes out not correct with the timed path
broken underneath; on a card, a short run of a cell."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from conftest import ROOT, SEED, tiny_cell

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def run_script(cwd, *extra):
    return subprocess.run([sys.executable, "stitchbench/run.py", "--workload", CELLS[0],
                           "--seed", str(SEED), "--seconds", "1", "--trace", "0", *extra],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_refused_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    out = run_script(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_refused_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "stitchbench", tmp_path / "stitchbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_script(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "image_stitch_tpu_torch" in out.stderr


def cpu_run(cell, program=None, trace=False):
    from stitchbench.run import run_cell

    return run_cell(cell, SEED, 0.3, trace, device="cpu", t_start=time.perf_counter(),
                    program=program, workers=2)


@pytest.mark.parametrize("name", CELLS)
def test_whole_run_on_the_cpu_is_correct(name):
    res = cpu_run(tiny_cell(name), trace=True)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert all(c["holds"] for c in res["checks"].values())
    checked = res["window"]["checked_jobs"]
    assert checked[-1] == res["attempted"] - 1 and len(checked) == len(set(checked)) <= 2
    assert res["checks"]["jobs_checked"]["value"] == len(checked)
    assert {"decode_layout.ms_per_band", f"{tiny_cell(name).options['outputFormat']}"
            "_encode.added_ms_per_band"} <= set(res["metrics"])
    pairs = res["window"]["layer_pairs"]
    assert len(pairs) == 2 and all(p["whole_bands"] == p["decode_bands"] > 0 for p in pairs)
    if name.startswith("png"):
        assert "png_idat_excess_pct" in res["checks"]


def test_the_draw_keeps_one_job_from_the_seed_and_the_last():
    from stitchbench.run import CheckDraw

    def kept(seed, n, failed=(), held=None):
        draw = CheckDraw(seed)
        for j in range(n):
            draw.offer(j, None if j in failed else b"x", j, last=j == n - 1)
            if held is not None:
                held.append(sum(x is not None for x in (draw.drawn, draw.last)))
        return [(k[0], k[3]) for k in draw.kept()]

    assert kept(7, 10) == kept(7, 10)
    assert kept(7, 1) == [(0, True)]
    for seed in range(20):
        held = []
        got = kept(seed, 9, held=held)
        assert got[-1][0] == 8 and got[0][1] and len(got) <= 2
        assert held[:-1] == [1] * 8            # one output held in the window, whatever the draw
        got = kept(seed, 9, failed={8})        # the last job failed: the draw alone
        assert len(got) == 1 and got[0][0] < 8
    drawn = [kept(seed, 8)[0][0] for seed in range(400)]
    assert set(drawn) == set(range(8))                 # any job of the window
    assert max(drawn.count(j) for j in range(8)) < 90  # about 50 each
    assert CheckDraw(1).kept() == []


def test_the_jpeg_tile_mix_on_the_cpu():
    """The JPEG-tile mix (no cell yet: see PERF.md, Open questions) through
    the whole run: the reference reads the tiles it made and lays them out."""
    from stitchbench.common.traffic import Traffic

    cell = tiny_cell("jpeg_q85.mosaic_10k")
    p = Traffic.load(ROOT / "stitchbench" / "traffic" / "jpeg_tiles.json").params
    p = json.loads(json.dumps(p))
    p["tiles"].update(width=48, height=40, count=6)
    p["grid"].update(columns=3, tiles_per_job=6)
    p.update(warmup_jobs=1)
    cell.traffic = Traffic("jpeg_tiles", p)
    res = cpu_run(cell)
    assert res["correct"], res["checks"]
    res = cpu_run(cell, program=altered_answer(streaming_program_cpu()))
    assert not res["correct"]


SPRITES = '''"""A background under opaque sprites, placed from the seed (positioned
layout): a kind of mix that no file of the harness knows."""

import numpy as np

from stitchbench.common.tiles import photo_rows
from stitchbench.common.traffic import Job, JobSpec, tag
from stitchbench.reference import png as ref_png


def make_state(seed, params, pool):
    b, s = params["background"], params["sprite"]
    return [ref_png.encode(photo_rows(seed, 0, b, b), 1)] + [
        ref_png.encode(photo_rows(seed, 1 + k, s, s), 1) for k in range(params["sprites"])]


def job(seed, params, state, index):
    b, s = params["background"], params["sprite"]
    rng = np.random.default_rng([seed % (1 << 64), 7, index])
    xy = rng.integers(0, b - s + 1, (params["sprites"], 2)).tolist()
    inputs = None if state is None else [{"x": 0, "y": 0, "source": tag(state[0], "png", str(index))}] + [
        {"x": x, "y": y, "source": tag(state[1 + k], "png", str(index))} for k, (x, y) in enumerate(xy)]
    return Job({"inputs": inputs}, JobSpec((b, b), ("stitchbench.kinds.sprites:rows", (seed, params, xy)),
                                            b * b * 4))


def rows(seed, params, xy, r0, r1):
    b, s = params["background"], params["sprite"]
    canvas = photo_rows(seed, 0, b, b)
    for k, (x, y) in enumerate(xy):
        canvas[y:y + s, x:x + s] = photo_rows(seed, 1 + k, s, s)
    return canvas[r0:r1]
'''

RUN_IN_COPY = '''import json, sys, time
sys.path.insert(0, sys.argv[1])
from pathlib import Path
from stitchbench.common.manifest import Cell
from stitchbench.run import run_cell
cell = Cell.load(Path(sys.argv[1]), sys.argv[2])
res = run_cell(cell, int(sys.argv[3]), 0.3, True, device="cpu", t_start=time.perf_counter(),
               workers=2)
print(json.dumps({k: res[k] for k in ("correct", "attempted", "metrics", "checks")}))
'''


@pytest.mark.parametrize("config", ["png_l6", "jpeg_q85"])
def test_a_mix_of_a_new_kind_runs_from_new_files_alone(tmp_path, config):
    """In a copy of the checkout, a kind of mix that is not a grid (a
    positioned background under sprites), its data file and a cell in the
    manifest are added as new files and entries; the whole run finds them
    by name, and comes out correct, with no file that was there edited."""
    root = tmp_path / "checkout"
    ignore = shutil.ignore_patterns("__pycache__")
    shutil.copytree(ROOT / "stitchbench", root / "stitchbench", ignore=ignore)
    shutil.copytree(ROOT / "image_stitch_tpu_torch", root / "image_stitch_tpu_torch", ignore=ignore)
    if (ROOT / "build" / "torch_native").is_dir():       # the port's C++ library, built once
        shutil.copytree(ROOT / "build" / "torch_native", root / "build" / "torch_native")
    before = {p: p.read_bytes() for p in (root / "stitchbench").rglob("*") if p.is_file()}
    bench = root / "stitchbench"
    (bench / "kinds" / "sprites.py").write_text(SPRITES)
    (bench / "traffic" / "sprites.json").write_text(json.dumps(
        {"kind": "sprites", "background": 96, "sprite": 24, "sprites": 5, "warmup_jobs": 1,
         "profile_jobs": 1, "layer_pairs": 2}))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["workloads"].append({"name": f"{config}.sprites", "config": config,
                                  "traffic": "sprites", "chips": 1, "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    out = subprocess.run([sys.executable, "-c", RUN_IN_COPY, str(root), f"{config}.sprites",
                          str(SEED)], cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["checks"]["jobs_checked"]["value"] >= 1 and res["attempted"] >= 1
    assert {p: p.read_bytes() for p in before} == before


def streaming_program_cpu():
    import image_stitch_tpu_torch as port

    from stitchbench.run import streaming_program

    return streaming_program(port, "cpu")


def altered_answer(program):
    """A byte of the job's output altered where it is produced: in the
    middle chunk."""
    def broken(options, counters):
        chunks = list(program(options, counters))
        k = len(chunks) // 2
        b = bytearray(chunks[k])
        b[len(b) // 2] ^= 0x10
        chunks[k] = bytes(b)
        return iter(chunks)
    return broken


def _copy(band):
    """A copy of a host array or of a tensor (JPEG tiles decode to one)."""
    return band.clone() if hasattr(band, "clone") else np.array(band)


def stale_bands(monkeypatch):
    """A step that returns its state unchanged: every band after the first
    comes out as the first band again."""
    from image_stitch_tpu_torch import core

    real = core.TorchStreamingConcatenator._grid_canvas_bands

    def grid_canvas_bands(self, *args):
        first = None
        for band in real(self, *args):
            if first is None:
                first = _copy(band)
                yield band
            else:
                yield _copy(first[: band.shape[0]])
    monkeypatch.setattr(core.TorchStreamingConcatenator, "_grid_canvas_bands", grid_canvas_bands)


def half_rows_left_out(monkeypatch):
    """Half of each band left out, the rest standing for it: every odd row
    is a copy of the row above."""
    from image_stitch_tpu_torch import core

    real = core.TorchStreamingConcatenator._grid_canvas_bands

    def grid_canvas_bands(self, *args):
        for band in real(self, *args):
            band = _copy(band)
            n = band[1::2].shape[0]
            band[1::2] = _copy(band[0::2][:n])
            yield band
    monkeypatch.setattr(core.TorchStreamingConcatenator, "_grid_canvas_bands", grid_canvas_bands)


@pytest.mark.parametrize("fault", ["altered_answer", "stale_bands", "half_rows_left_out"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_path_is_not_correct(name, fault, monkeypatch):
    import image_stitch_tpu_torch as port

    from stitchbench.run import streaming_program

    program = streaming_program(port, "cpu")
    if fault == "altered_answer":
        program = altered_answer(program)
    else:
        globals()[fault](monkeypatch)
    res = cpu_run(tiny_cell(name), program=program)
    assert res["failed"] == 0
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
def test_a_short_run_on_the_card(cuda_card):
    out = subprocess.run([sys.executable, "stitchbench/run.py", "--workload",
                          "jpeg_q85.mosaic_10k", "--seed", str(SEED), "--seconds", "8",
                          "--trace", "1"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) >= {"decode_layout.ms_per_band", "device.idle_pct"}
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
