"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<config>.<mix>`` resolves to ``stitchbench/configs/<config>.json``
(through the configuration's ``file``), ``stitchbench/traffic/<mix>.json``
(whose ``kind`` names its generator, ``stitchbench/kinds/<kind>.py``) and,
for each metric that the cell reports, ``stitchbench/metrics/<metric>.py``
with a function ``read(trace)`` that returns a number or None. Adding a cell,
a configuration, a mix, a kind of mix or a metric adds files and manifest
entries and edits nothing.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

from stitchbench.common.traffic import Traffic

BENCH = Path(__file__).resolve().parents[1]


@dataclass
class Metric:
    name: str
    unit: str
    spec: dict

    def reader(self, bench: Path = BENCH):
        path = bench / "metrics" / f"{self.name}.py"
        spec = importlib.util.spec_from_file_location(f"stitchbench_metric_{self.name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic: Traffic
    end_to_end: list[Metric]
    per_layer: list[Metric]

    @property
    def options(self) -> dict:
        return self.config["options"]

    @classmethod
    def load(cls, root: Path, name: str, bench: Path = BENCH) -> "Cell":
        manifest = json.loads((root / "BENCHMARK.json").read_text())
        found = [w for w in manifest["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        work = found[0]
        conf = next(c for c in manifest["configs"] if c["name"] == work["config"])
        config = json.loads((root / conf["file"]).read_text())
        traffic = Traffic.load(bench / "traffic" / f"{work['traffic']}.json")

        def mine(metrics):
            return [Metric(m["name"], m["unit"], m) for m in metrics
                    if name in m.get("workloads", [name])]

        return cls(name, work["chips"], conf["name"], config, traffic,
                   mine(manifest["end_to_end"]), mine(manifest["per_layer"]))
