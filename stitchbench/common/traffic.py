"""Traffic mixes: a data file of parameters, read by the generator of its kind.

A traffic file (``traffic/<mix>.json``) holds parameters only. Its ``kind``
names the generator, the module ``stitchbench/kinds/<kind>.py``, found by
name: a mix of a new kind adds that module and its data file, and edits no
file that is there. The harness reads three keys of every mix itself:

- ``warmup_jobs``: jobs run in set-up, on the window's own shapes;
- ``profile_jobs``: the jobs of a traced run's profiled slice;
- ``layer_pairs``: the traced run's pairs of a whole job and a pass of
  decode and layout alone, in turns.

A kind module defines two functions:

- ``make_state(seed, params, pool)``: the inputs made once in set-up, on
  the pool's workers (tiles, backgrounds, files);
- ``job(seed, params, state, index)``: job ``index`` as a ``Job``: the
  options it adds to the configuration's (``inputs``, ``layout``) and its
  ``JobSpec``.

Everything that counts or judges a job reads its ``JobSpec`` alone: the
canvas, where the reference rebuilds its rows, and the bytes its inputs
put on the card. No two jobs may hand the program byte-identical inputs
(``tag`` gives each input a per-job ancillary chunk).
"""

from __future__ import annotations

import importlib
import json
import math
from dataclasses import dataclass
from pathlib import Path

from stitchbench.reference import png as ref_png

WARMUP = 1 << 40          # job indices of set-up's jobs start here
PROFILE = WARMUP + 1000   # ... of the profiled slice's
PAIRS = WARMUP + 2000     # ... of the layer pairs'


@dataclass(frozen=True)
class JobSpec:
    """What a job makes, as the yardstick reads it.

    ``rows`` is ``("module:function", args)``: ``function(*args, r0, r1)``
    returns canvas rows r0:r1 as (r1 - r0, width, 4) uint8, rebuilt from the
    seed by the plain reference (it runs on the pool's workers, so the
    module lies under ``stitchbench``). ``input_bytes`` is what the card
    must read of the job's inputs: the canvas's pixels, or the coefficients
    of tiles that it decodes itself."""

    canvas: tuple[int, int]          # (height, width)
    rows: tuple[str, tuple]
    input_bytes: int

    @property
    def megapixels(self) -> float:
        return self.canvas[0] * self.canvas[1] / 1e6

    def bands(self, band_height: int) -> int:
        return math.ceil(self.canvas[0] / band_height)


@dataclass
class Job:
    options: dict
    spec: JobSpec


def canvas_rows(rows: tuple[str, tuple], r0: int, r1: int):
    """Rows r0:r1 of a job's canvas from its ``JobSpec.rows``."""
    target, args = rows
    module, name = target.split(":")
    if module.split(".")[0] != "stitchbench":
        raise ValueError(f"{target} is not under stitchbench")
    return getattr(importlib.import_module(module), name)(*args, r0, r1)


@dataclass(frozen=True)
class Traffic:
    name: str
    params: dict

    @classmethod
    def load(cls, path: Path) -> "Traffic":
        return cls(path.stem, json.loads(path.read_text()))

    @property
    def kind(self):
        return importlib.import_module(f"stitchbench.kinds.{self.params['kind']}")

    def make_state(self, seed: int, pool):
        return self.kind.make_state(seed, self.params, pool)

    def job(self, seed: int, state, index: int) -> Job:
        return self.kind.job(seed, self.params, state, index)


def tag(data: bytes, fmt: str, text: str) -> bytes:
    """``data`` with an ancillary chunk (PNG, after IHDR) or a COM segment
    (JPEG, after SOI) carrying ``text``."""
    view = memoryview(data)
    if fmt == "png":
        return b"".join((view[:33], ref_png.text_chunk("Comment", text), view[33:]))
    payload = text.encode("latin-1")
    return b"".join((view[:2], b"\xff\xfe", (len(payload) + 2).to_bytes(2, "big"), payload,
                     view[2:]))
