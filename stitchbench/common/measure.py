"""Samplers and the profiled slice.

- ``RssSampler``: the process's resident set, sampled every few ms on a
  thread (``bench.py``'s ``monitor_rss``, read the way the upstream's
  ``monitorMemory`` reads it, at a finer period).
- ``StackSampler``: which function of the program the main thread is in,
  every millisecond; labels the device's idle gaps.
- ``profile_slice``: ``torch.profiler`` over some whole jobs, after lead
  spin kernels that absorb the first records a long process can lose
  (``chip_smoke.py``'s ``device_profile``). Device activities (kernels,
  copies, memsets) are put on the host clock through a marker span.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import defaultdict
from pathlib import Path

from stitchbench.common.work import gaps, union_seconds

PROFILE_LEAD = 64
PACKAGE = "image_stitch_tpu_torch"


class RssSampler:
    def __init__(self, period_s: float = 0.005):
        self.period_s = period_s
        self.peak = 0
        self._stop = threading.Event()
        self._fd = os.open("/proc/self/statm", os.O_RDONLY)
        self._page = os.sysconf("SC_PAGE_SIZE")
        self._thread = threading.Thread(target=self._run, name="rss-sampler", daemon=True)

    def read(self) -> int:
        return int(os.pread(self._fd, 128, 0).split()[1]) * self._page

    def _run(self) -> None:
        while not self._stop.is_set():
            self.peak = max(self.peak, self.read())
            self._stop.wait(self.period_s)

    def __enter__(self) -> "RssSampler":
        self.peak = self.read()
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        self.peak = max(self.peak, self.read())
        os.close(self._fd)


def frame_label(frame) -> str:
    """The innermost frame in the program's package, as path:function;
    else the innermost frame."""
    f = frame
    while f is not None:
        path = f.f_code.co_filename
        if f"{os.sep}{PACKAGE}{os.sep}" in path:
            rel = path.split(f"{os.sep}{PACKAGE}{os.sep}", 1)[1]
            return f"{rel}:{f.f_code.co_name}"
        f = f.f_back
    return f"{Path(frame.f_code.co_filename).name}:{frame.f_code.co_name}"


class StackSampler:
    def __init__(self, period_s: float = 0.001):
        self.period_s = period_s
        self.samples: list[tuple[float, float, str]] = []   # (time, seconds, label)
        self._main = threading.main_thread().ident
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="stack-sampler", daemon=True)

    def _run(self) -> None:
        last = time.perf_counter()
        while not self._stop.wait(self.period_s):
            frame = sys._current_frames().get(self._main)
            now = time.perf_counter()
            if frame is not None:
                self.samples.append((now, now - last, frame_label(frame)))
            last = now

    def __enter__(self) -> "StackSampler":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=5)


def _is_copy(name: str) -> bool:
    low = name.lower()
    return low.startswith("memcpy") or low.startswith("memset")


def profile_slice(run_jobs) -> dict:
    """Run ``run_jobs()`` (which returns what it wants kept) under the
    profiler; return the slice's wall, device busy time (union of
    activities), kernel time, top device operations, idle time by host
    function, and ``run_jobs``'s result under "jobs"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_LEAD):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        with StackSampler() as stacks:
            t0 = time.perf_counter()
            with record_function("stitchbench.slice"):
                jobs = run_jobs()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
    events = prof.events()
    marker = next(e for e in events if e.name == "stitchbench.slice")
    offset = t0 - marker.time_range.start / 1e6
    device, lead = [], 0
    for e in events:
        # record_function ranges show on the device too, as annotations
        if e.device_type != DeviceType.CUDA or e.name == "stitchbench.slice" or \
                getattr(e, "is_user_annotation", False):
            continue
        if "spin" in e.name:
            lead += 1
            continue
        device.append((e.name, e.time_range.start / 1e6 + offset, e.time_range.end / 1e6 + offset))
    inside = [(n, a, b) for n, a, b in device if b > t0 and a < t1]
    spans = [(a, b) for _, a, b in inside]
    by_op: dict[str, float] = defaultdict(float)
    for n, a, b in inside:
        by_op[n] += b - a
    idle: dict[str, float] = defaultdict(float)
    holes = gaps(spans, t0, t1)
    k = 0
    for t, dt, label in stacks.samples:               # both sorted by time
        while k < len(holes) and holes[k][1] < t:
            k += 1
        if k < len(holes) and holes[k][0] <= t:
            idle[label] += dt
    return {
        "wall_s": t1 - t0,
        "busy_s": union_seconds(spans, t0, t1),
        "kernel_s": sum(b - a for n, a, b in inside if not _is_copy(n)),
        "activities": len(inside),
        "outside": len(device) - len(inside),
        "lead_kept": lead,
        "device_ops": sorted(by_op.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1])[:10],
        "jobs": jobs,
    }
