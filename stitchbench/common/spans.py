"""The program's own spans (``image_stitch_tpu_torch.utils.observability``:
``spans()``, records of name, start and end in ``perf_counter_ns``, parent
and ``n`` bytes) that lie inside the jobs of the traced run's profiled
slice, for the readers that time a layer where its work happens. Jobs are
traced there because the profiler records at their start; the window runs
untraced. Without a profiled slice, or with a program that records no
spans, the readers give None."""

from __future__ import annotations

import importlib

RECORDER = "image_stitch_tpu_torch.utils.observability"


def profiled_spans(trace):
    """(the spans inside the profiled slice's finished jobs, those jobs'
    bands), or None."""
    p = trace.profile
    jobs = [j for j in (p or {}).get("jobs") or () if j.error is None]
    if not jobs:
        return None
    try:
        spans = getattr(importlib.import_module(RECORDER), "spans", None)
    except ImportError:
        return None
    if spans is None:
        return None
    windows = [(j.t_call * 1e9, j.t_end * 1e9) for j in jobs]
    inside = [s for s in spans() if any(a <= s.start and s.end <= b for a, b in windows)]
    return inside, sum(j.bands for j in jobs)


def top_level(records):
    """The spans a job opened on its own thread outside any other: the
    children of its ``job`` span."""
    roots = {r.id for r in records if r.name == "job"}
    return [r for r in records if r.parent in roots]


def ms_per_band(trace, names, less=(), top=()):
    """Milliseconds a band: the summed durations of the spans named in
    ``names`` and of the top-level spans named in ``top``, less those named
    in ``less``; None where none of ``names`` or ``top`` was recorded."""
    got = profiled_spans(trace)
    if got is None:
        return None
    records, bands = got
    chosen = [r for r in records if r.name in names]
    chosen += [r for r in top_level(records) if r.name in top]
    if not chosen or not bands:
        return None
    ns = sum(r.end - r.start for r in chosen)
    ns -= sum(r.end - r.start for r in records if r.name in less)
    return ns / 1e6 / bands


def gb_per_s(trace, name):
    """The summed ``n`` bytes of the spans named ``name`` over their summed
    durations, in GB/s; None where none was recorded."""
    got = profiled_spans(trace)
    if got is None:
        return None
    chosen = [r for r in got[0] if r.name == name]
    ns = sum(r.end - r.start for r in chosen)
    if not chosen or ns <= 0:
        return None
    return sum(r.n for r in chosen) / ns
