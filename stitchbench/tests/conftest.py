"""Shared fixtures of the benchmark's own tests (run with
``python -m pytest stitchbench/tests``; the card's tests with ``-m cuda``)."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SEED = (1 << 31) + 4321       # larger than 32 signed bits hold


def tiny_cell(name: str, width: int = 48, height: int = 40):
    """The cell ``name`` of BENCHMARK.json cut to tiles of 48 x 40 (or
    ``width`` x ``height``), six a job, and 16-row bands: the harness's
    whole path at a size a test holds."""
    from stitchbench.common.manifest import Cell
    from stitchbench.common.traffic import Traffic

    cell = Cell.load(ROOT, name)
    p = json.loads(json.dumps(cell.traffic.params))
    p["tiles"].update(width=width, height=height, count=6)
    p["grid"].update(columns=3, tiles_per_job=6)
    p.update(warmup_jobs=1, profile_jobs=1, layer_pairs=2)
    cell.traffic = Traffic(cell.traffic.name, p)
    cell.config = json.loads(json.dumps(cell.config))
    cell.config["options"]["bandHeight"] = 16
    return cell


@pytest.fixture(scope="session")
def pool():
    from stitchbench.common.pool import Pool

    with Pool(2) as p:
        yield p


@pytest.fixture
def cuda_card():
    """Skips unless a CUDA card is there; decided when the test runs."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
