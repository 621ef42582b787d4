"""Tracing, profiling, and streaming telemetry.

The reference has no tracing/profiling subsystem (SURVEY §5: ABSENT; nearest
analog is the test-only memory sampler, tests/utils/memory-monitor.ts:77-126).
The port makes it first-class:

- :func:`device_trace` wraps a region with ``torch.profiler`` so the
  port's functions (Python stacks), its spans and, on a card, its kernels
  and copies show up in one Chrome trace (TensorBoard, Perfetto,
  chrome://tracing).
- :func:`span` marks a piece of a job's host work: decode, assembly, each
  encoder's submit, wait and the pieces between. A job is traced when a
  torch profiler records at its start (``device_trace``, an operator's own
  ``torch.profiler``); untraced, a span is one check of a module global and
  records nothing. Traced, each span is also a named range in the
  profiler's trace (torch's fast ``RecordFunction``, else
  ``record_function``), and a :class:`Span` record in :data:`RECORDER`,
  stamped with ``time.perf_counter_ns()``.
- :class:`PipelineStats` counts bands, pixels and emitted bytes, and gives
  a traced job's self time per span name.

The spans of a job (``n``: a count of bytes, where there is one):

- ``job``: the call of ``stream()`` to its exhaustion, one record; the
  parent of the spans the job opens on its own thread; ``n`` bytes out.
- ``decode.png``: one tile's next rows (``RowSource._pull``), the parse and
  chunk CRCs included; under it ``decode.inflate``
  (``NativeInflater.drain_into``, ``n`` bytes out) and ``decode.defilter``
  (``defilter_units_native``, ``defilter_band_native``).
- ``decode.jpeg.open``: a JPEG tile opened by the device decode tier (its
  ``DeviceJpegDecoder`` built, ``JpegDecoder.device_band_decoder``, from
  ``DeviceTileBands.serves``), ``n`` the tile's file bytes; under it
  ``decode.jpeg.entropy`` (``decode_coefficients``, the host Huffman
  decode, ``n`` the same bytes); the zigzag-prefix extraction is its own
  time.
- ``decode.jpeg.band``: a band of JPEG tiles decoded on the device
  (``DeviceTileBands.band``, and ``DeviceJpegDecoder.decode_band`` for
  one tile); under it ``decode.jpeg.stage`` (``stage_tiles_band``: the tables,
  the copies into the staging ring's slot, the queued upload; ``n`` the
  staged bytes) and ``decode.jpeg.launch`` (the two kernels' launches).
- ``assemble``: a host band of the grid, from its canvas to its yield: the
  tile pulls and ``trim_malloc``.
- ``jpeg.submit`` (``TorchJpegEncoder.submit``), under it ``jpeg.upload``
  (a host band staged and its copy to the device queued; ``n`` is the
  band's colour bytes, H×W×3, though the staged copy carries the band as
  it lies, with alpha: 4/3 of ``n`` for RGBA) with ``jpeg.upload.copy``
  (the copy into the staging ring's buffer);
  ``jpeg.wait`` (``TorchJpegEncoder.wait``), under it ``jpeg.device_wait``
  (the first blocking read-back, ``n`` bytes read) and ``jpeg.stuff``
  (``n`` bytes out).
- ``png.submit`` (``TorchBackend.png_filter_band_async``), under it
  ``png.upload`` (``n`` bytes onto the device); ``png.device_wait`` (the
  event syncs of ``png_filter_band_wait``); ``png.deflate``
  (``StreamingDeflator.push`` and ``finish``, ``n`` bytes in: the job's
  thread's share of the deflate, the batch's copy, its Adler-32 and the
  waits), under it ``png.deflate.wait`` (blocked on a batch in flight);
  ``png.deflate.batch`` (``NativeDeflator._compress_batch``, one batch
  compressed, ``n`` raw bytes: on a deflate worker a span without a
  parent, the final batch at host threads 1 under ``png.deflate``);
  ``png.idat`` (an IDAT chunk framed, its CRC included, ``n`` bytes out).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterable, Iterator, NamedTuple

CAP = 1 << 18  # records the recorder keeps; later ones are counted in ``dropped``


@contextlib.contextmanager
def device_trace(log_dir: str | None = None):
    """Profile a region with torch.profiler; no-op when log_dir is None and
    STITCH_TPU_TRACE_DIR is unset.

    Records CPU activity with Python stacks, and CUDA activity (kernels,
    copies, memsets) when a card is present; jobs started inside the region
    are traced, so their spans show too. On exit writes one Chrome trace, a
    ``*.pt.trace.json`` file, into ``log_dir``
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


# --------------------------------------------------------------------------- #
# Spans
# --------------------------------------------------------------------------- #


class Span(NamedTuple):
    """One closed span. ``start``/``end`` are ``time.perf_counter_ns()``;
    ``parent`` is the id of the span that was innermost open on the same
    thread when it opened (a job's ``job`` span on the job's thread, None
    on another thread); ``job`` the id of the job it worked for."""

    name: str
    start: int
    end: int
    id: int
    parent: int | None
    job: int
    thread: int
    n: int


class Recorder:
    """Closed spans in memory, in the order they closed: at most ``cap``;
    past it a span is counted in ``dropped`` and not kept."""

    def __init__(self, cap: int = CAP):
        self.cap = cap
        self.records: list[Span] = []
        self.dropped = 0
        self._lock = threading.Lock()

    def add(self, record: Span) -> None:
        with self._lock:
            if len(self.records) < self.cap:
                self.records.append(record)
            else:
                self.dropped += 1

    def spans(self) -> list[Span]:
        with self._lock:
            return list(self.records)

    def clear(self) -> None:
        with self._lock:
            self.records = []
            self.dropped = 0


RECORDER = Recorder()


class _ThreadState(threading.local):
    def __init__(self):
        self.job: int | None = None   # the job this thread works for now
        self.open: list[int] = []     # ids of the spans open here, innermost last


_thread = _ThreadState()
_ids = itertools.count(1)
_job_ids = itertools.count(1)
_live = 0                      # traced jobs not yet exhausted or closed
_live_lock = threading.Lock()
_record_function = None        # torch's range, bound when a job is traced


class _Off:
    """The span of untraced work: records nothing, keeps nothing."""

    __slots__ = ()
    n = property(lambda self: 0, lambda self, value: None)

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "n", "job", "id", "parent", "start", "_range")

    def __init__(self, name: str, n: int, job: int):
        self.name, self.n, self.job = name, n, job

    def __enter__(self) -> "_On":
        opened = _thread.open
        self.parent = opened[-1] if opened else None
        self.id = next(_ids)
        opened.append(self.id)
        self._range = _record_function(self.name)
        self._range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        self._range.__exit__(*exc)
        _thread.open.pop()
        RECORDER.add(Span(self.name, self.start, end, self.id, self.parent, self.job,
                          threading.get_ident(), self.n))
        return False


def span(name: str, n: int = 0):
    """A context manager timing a piece of the current job's work; ``n``
    (bytes) may be given here or set on the value it binds. Records only
    inside a traced job. Open and close it within one synchronous call:
    never across a ``yield``."""
    if not _live:
        return _OFF
    job = _thread.job
    if job is None:
        return _OFF
    return _On(name, n, job)


def next_job() -> int:
    return next(_job_ids)


def profiled() -> bool:
    """Whether a torch profiler records in this process now."""
    from torch.autograd import profiler

    return bool(profiler._is_profiler_enabled)


def traced(job: int, chunks: Iterator[bytes], start: int) -> Iterator[bytes]:
    """``chunks`` as the work of ``job``: the job is current on this thread
    during each resumption of ``chunks`` and not across a ``yield``, so
    interleaved jobs keep their own ids. At exhaustion one ``job`` span
    from ``start`` (``perf_counter_ns`` at the call) is recorded."""
    global _live, _record_function
    from torch._C import _profiler
    from torch.autograd.profiler import record_function

    # The fast RecordFunction makes the same named range in the profiler's
    # trace as record_function at a third of the cost: a span took 6.9 us
    # against 17.6 us on an H100 machine's host under the profiler.
    _record_function = getattr(_profiler, "_RecordFunctionFast", record_function)
    root, out = next(_ids), 0
    with _live_lock:
        _live += 1
    try:
        while True:
            prev = _thread.job
            _thread.job = job
            _thread.open.append(root)
            try:
                chunk = next(chunks)
            except StopIteration:
                break
            finally:
                _thread.open.pop()
                _thread.job = prev
            out += len(chunk)
            yield chunk
        RECORDER.add(Span("job", start, time.perf_counter_ns(), root, None, job,
                          threading.get_ident(), out))
    finally:
        chunks.close()
        with _live_lock:
            _live -= 1


class JobPool(ThreadPoolExecutor):
    """A thread pool whose tasks work for the job that submitted them."""

    def submit(self, fn, /, *args, **kwargs):
        job = _thread.job if _live else None
        if job is None:
            return super().submit(fn, *args, **kwargs)

        def run():
            prev = _thread.job
            _thread.job = job
            try:
                return fn(*args, **kwargs)
            finally:
                _thread.job = prev

        return super().submit(run)


def spans() -> list[Span]:
    """The spans the recorder keeps."""
    return RECORDER.spans()


def clear() -> None:
    RECORDER.clear()


def self_seconds(records: Iterable[Span]) -> dict[str, float]:
    """Seconds by span name, each span's duration less its children's."""
    records = list(records)
    children: dict[int, int] = defaultdict(int)
    for r in records:
        if r.parent is not None:
            children[r.parent] += r.end - r.start
    out: dict[str, float] = defaultdict(float)
    for r in records:
        out[r.name] += (r.end - r.start - children[r.id]) / 1e9
    return dict(out)


@dataclass
class PipelineStats:
    """Counters of one streaming run; ``job`` is its id in the recorder when
    the run was traced."""

    bands: int = 0
    pixels: int = 0
    output_bytes: int = 0
    job: int | None = None

    def record_band(self, h: int, w: int) -> None:
        self.bands += 1
        self.pixels += h * w

    def record_output(self, n: int) -> None:
        self.output_bytes += n

    def report(self) -> dict:
        """Counts, and a traced run's self seconds by span name."""
        stages = {}
        if self.job is not None:
            stages = self_seconds(r for r in spans() if r.job == self.job)
        return {
            "bands": self.bands,
            "megapixels": round(self.pixels / 1e6, 3),
            "output_bytes": self.output_bytes,
            "stages": {k: round(v, 6) for k, v in stages.items()},
        }
