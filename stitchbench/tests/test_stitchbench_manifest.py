"""BENCHMARK.json against the benchmark's contract, and every name in it
resolving to its files."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "stitchbench/run.py"]
    assert MANIFEST["paths"] == ["stitchbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_text():
    names = []
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"]) and c["source"].startswith("https://")
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and one_line(w["why"])
        assert NAME.match(w["traffic"]) and w["name"] == f"{w['config']}.{w['traffic']}"
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("host_clock", "device_trace", "program_span", "program_counter")
        assert one_line(m["layer"])
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    names += CELLS
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in MANIFEST["end_to_end"])


@pytest.mark.parametrize("cell_name", CELLS)
def test_cell_resolves_by_name(cell_name):
    from stitchbench.common.manifest import Cell

    cell = Cell.load(ROOT, cell_name)
    assert cell.traffic.job(1, None, 0).spec.megapixels > 0
    assert (ROOT / "stitchbench" / "kinds" / f"{cell.traffic.params['kind']}.py").is_file()
    e2e = {m.name for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(m.reader())
    for m in cell.per_layer:
        assert m.spec["moves"] in e2e, f"{m.name} moves {m.spec['moves']}, not reported here"
    conf = next(c for c in MANIFEST["configs"] if c["name"] == cell.config_name)
    assert conf["file"].startswith("stitchbench/configs/")
    assert set(cell.config["reduced"]) == set(conf["reduced"])


def test_every_config_used_and_every_file_named():
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    for path in (ROOT / "stitchbench").rglob("*"):
        assert re.match(r"^[A-Za-z0-9_.\-/]+$", str(path.relative_to(ROOT)))


def test_a_new_cell_is_found_from_new_files_alone(tmp_path):
    """A throwaway configuration, mix and per-layer metric, added as files
    and manifest entries in a copy, resolve and read without an edit to any
    file already there."""
    from stitchbench.common.manifest import Cell

    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "stitchbench", root / "stitchbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "stitchbench").rglob("*") if p.is_file()}
    bench = root / "stitchbench"
    (bench / "configs" / "png_l1.json").write_text(json.dumps(
        {"source": "x", "options": {"outputFormat": "png", "pngCompressionLevel": 1,
                                    "bandHeight": 64}, "assumed": {}, "reduced": []}))
    traffic = json.loads((bench / "traffic" / "mosaic_10k.json").read_text())
    traffic["grid"].update(columns=2, tiles_per_job=4)
    (bench / "traffic" / "pair.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "jobs.count.py").write_text(
        "def read(trace):\n    return float(len(trace.jobs))\n")
    manifest = json.loads(json.dumps(MANIFEST))
    manifest["configs"].append({"name": "png_l1", "source": "https://example.org", "why": "x",
                                "file": "stitchbench/configs/png_l1.json", "reduced": []})
    manifest["workloads"].append({"name": "png_l1.pair", "config": "png_l1", "traffic": "pair",
                                  "chips": 1, "why": "x"})
    manifest["per_layer"].append({"name": "jobs.count", "unit": "1", "better": "higher",
                                  "source": "host_clock", "layer": "API", "moves": "setup_s",
                                  "workloads": ["png_l1.pair"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    cell = Cell.load(root, "png_l1.pair", bench=bench)
    assert cell.options["pngCompressionLevel"] == 1
    assert cell.traffic.params["grid"]["columns"] == 2
    assert [m.name for m in cell.per_layer] == ["jobs.count"]

    class T:
        jobs = [1, 2, 3]

    assert cell.per_layer[0].reader(bench)(T) == 3.0
    after = {p: p.read_bytes() for p in before}
    assert after == before
