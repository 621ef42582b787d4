"""A small pool of worker processes over pipes.

``multiprocessing`` keeps its locks in named semaphores under /dev/shm; the
benchmark writes nothing outside its checkout and the run's own home and
temporary directories, so its workers are plain child processes that read
tasks from their standard input and write results to their standard output,
each a length-prefixed pickle. A task names a function of a module under
``stitchbench`` and its arguments. Workers start without torch and with one
BLAS thread each. Every worker is waited for on ``close``.
"""

from __future__ import annotations

import os
import pickle
import selectors
import struct
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
_LEN = struct.Struct(">Q")


def send(stream, obj) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    stream.write(_LEN.pack(len(data)))
    stream.write(data)
    stream.flush()


def receive(stream):
    """The next message, or None at the end of the stream."""
    head = stream.read(_LEN.size)
    if len(head) < _LEN.size:
        return None
    (n,) = _LEN.unpack(head)
    data = stream.read(n)
    if len(data) < n:
        raise EOFError("a worker's message was cut short")
    return pickle.loads(data)


def default_workers() -> int:
    return max(1, min(8, len(os.sched_getaffinity(0))))


class Pool:
    """``map`` runs ``module:function`` over argument tuples in the workers
    and returns the results in order; a task that raises re-raises here
    with the worker's traceback."""

    def __init__(self, workers: int | None = None):
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                   OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")
        self._procs = [
            subprocess.Popen([sys.executable, "-m", "stitchbench.common.worker"], cwd=ROOT,
                             env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE)
            for _ in range(workers or default_workers())
        ]

    def map(self, target: str, arg_list: list[tuple]) -> list:
        results: list = [None] * len(arg_list)
        pending = list(enumerate(arg_list))[::-1]
        sel = selectors.DefaultSelector()
        busy = 0
        try:
            for proc in self._procs:
                if not pending:
                    break
                i, args = pending.pop()
                send(proc.stdin, (i, target, args))
                sel.register(proc.stdout, selectors.EVENT_READ, proc)
                busy += 1
            while busy:
                for key, _ in sel.select():
                    proc = key.data
                    msg = receive(proc.stdout)
                    if msg is None:
                        raise RuntimeError(f"worker {proc.pid} ended with code {proc.wait()}")
                    i, ok, value = msg
                    if not ok:
                        raise RuntimeError(f"task {target}{arg_list[i]!r:.200} failed:\n{value}")
                    results[i] = value
                    if pending:
                        j, args = pending.pop()
                        send(proc.stdin, (j, target, args))
                    else:
                        sel.unregister(proc.stdout)
                        busy -= 1
        finally:
            sel.close()
        return results

    def close(self) -> None:
        for proc in self._procs:
            try:
                proc.stdin.close()
            except OSError:
                pass
        for proc in self._procs:
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            proc.stdout.close()
        self._procs = []

    def __enter__(self) -> "Pool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
