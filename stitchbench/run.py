"""Run one cell of the benchmark of ``image_stitch_tpu_torch`` once.

    python3 stitchbench/run.py --workload <config>.<mix> --seed N --seconds S --trace 0|1

From the root of a checkout that holds ``BENCHMARK.json``, ``stitchbench/``
and the port's package. In order:

1. set-up (``setup_s``, from the start of this process): torch and the CUDA
   context, the kernels from the build cache under ``build/`` (built there
   on a checkout's first run), the cell's inputs made from the seed by
   its mix's kind (``stitchbench/kinds/``) on a pool of worker processes,
   and ``warmup_jobs`` jobs of the cell's own shapes;
2. the window: one caller, a closed loop. Each job calls
   ``image_stitch_tpu_torch.concat_streaming(options, device="cuda")`` and
   joins its chunks in memory before the next job starts. Jobs start until
   ``--seconds`` have passed; the job in flight then runs to its end, and
   the window closes with its last chunk, so every rate covers all the work
   and all the time of the window. The resident set is sampled every 5 ms
   and the card's allocation peak is reset at the window's start;
3. with ``--trace 1``: a profiled slice of whole jobs (device busy time,
   kernel time, idle gaps by host function), then ``layer_pairs`` pairs of
   a whole job and a pass of the program's decode and layout alone
   (``stream_bands``, no encoder), in turns;
4. the check: the output of one job drawn from the seed among all the
   window's jobs, and of the window's last job, against the plain
   reference under ``stitchbench/reference``, rebuilt on worker processes;
5. the result: the numbers compared, each beside its limit, as the last
   lines of standard error, then one JSON line on standard output.

It exits non-zero and prints no result without a CUDA card (or with fewer
than the cell's chips), without the port's package in the checkout, or if
JAX or the JAX package was loaded. Caches stay inside the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = "image_stitch_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "image_stitch_tpu")


class RunError(Exception):
    """The run cannot give a result."""


@dataclass
class JobRecord:
    t_call: float
    t_first: float
    t_end: float
    spec: object
    bands: int
    out_bytes: int
    error: str | None = None
    cpu_s: float = 0.0

    @property
    def megapixels(self) -> float:
        return self.spec.megapixels


@dataclass
class Trace:
    """What a run measured; every metric reader reads one of these."""
    cell: object
    setup_s: float
    jobs: list
    window_s: float
    rss_peak_bytes: int
    device_peak_bytes: int
    counters: dict
    profile: dict | None = None
    layer_pairs: list | None = None


def prepare_environment() -> None:
    """Fixed cache directories inside the checkout, and none of the port's
    STITCH_TPU_* switches: the configuration alone states the options."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    for key in [k for k in os.environ if k.startswith("STITCH_TPU_")]:
        del os.environ[key]


def load_port():
    """The port's package from this checkout, never from elsewhere."""
    if not (ROOT / PORT / "__init__.py").is_file():
        raise RunError(f"{PORT}/ is not in the checkout {ROOT}")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import importlib

    port = importlib.import_module(PORT)
    if Path(port.__file__).resolve().parent != ROOT / PORT:
        raise RunError(f"{PORT} was imported from {port.__file__}, not from the checkout")
    return port


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def streaming_program(port, device):
    def program(options, counters):
        return port.concat_streaming(options, device=device, counters=counters)
    return program


def run_job(program, cell, job, counters) -> tuple[JobRecord, bytes | None]:
    options = dict(cell.options, **job.options)
    chunks = []
    cpu0 = time.process_time()
    t_call = time.perf_counter()
    t_first = None
    try:
        for chunk in program(options, counters):
            if t_first is None:
                t_first = time.perf_counter()
            chunks.append(chunk)
        out = b"".join(chunks)
        error = None
    except Exception as e:  # a failed job counts, and the loop goes on
        out, error = None, f"{type(e).__name__}: {e}"
    t_end = time.perf_counter()
    rec = JobRecord(t_call, t_first if t_first is not None else t_end, t_end, job.spec,
                    job.spec.bands(cell.options["bandHeight"]),
                    len(out) if out is not None else 0, error, time.process_time() - cpu0)
    return rec, out


class CheckDraw:
    """Which outputs of the window are kept for the check: one job drawn
    from the seed, uniformly among all that finished in the window (a
    reservoir of one), and the window's last job, which ran after every
    other call of the process. Through the window exactly one output is
    held, whichever the draw, so that the resident set does not depend on
    the seed; the last job's is kept once the window has closed."""

    def __init__(self, seed: int):
        import numpy as np

        self._rng = np.random.default_rng(np.random.SeedSequence([seed % (1 << 64), 3]))
        self._seen = 0
        self.drawn = None           # (job index, output, spec)
        self.last = None

    def offer(self, j: int, out: bytes | None, spec, last: bool = False) -> None:
        if out is None:
            return
        self._seen += 1
        if self._rng.random() * self._seen < 1.0:
            self.drawn = (j, out, spec)
        if last:
            self.last = (j, out, spec)

    def kept(self) -> list[tuple[int, bytes, object, bool]]:
        """(job, output, spec, whether its PNG size is compared): the drawn
        job's is, the last job's rows and format only."""
        out = [] if self.drawn is None else [(*self.drawn, True)]
        if self.last is not None and (self.drawn is None or self.last[0] != self.drawn[0]):
            out.append((*self.last, self.drawn is None))
        return out


def window(program, cell, seed, state, seconds, counters, device):
    """The measured closed loop; returns (records, the draw of outputs to
    check, window seconds, peak RSS, peak device bytes)."""
    from stitchbench.common.measure import RssSampler

    if device != "cpu":
        import torch

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    records, draw = [], CheckDraw(seed)
    with RssSampler() as rss:
        t0 = time.perf_counter()
        deadline = t0 + seconds
        j = 0
        while True:
            rec, out = run_job(program, cell, cell.traffic.job(seed, state, j), counters)
            records.append(rec)
            draw.offer(j, out, rec.spec, last=rec.t_end >= deadline)
            del out
            j += 1
            if rec.t_end >= deadline:
                break
        window_s = records[-1].t_end - t0
    peak_device = 0
    if device != "cpu":
        import torch

        peak_device = torch.cuda.max_memory_allocated()
    return records, draw, window_s, rss.peak, peak_device


def layer_pairs(program, cell, seed, state, device) -> list[dict]:
    """Pairs of a whole job through ``program`` and a pass of the program's
    decode and layout alone (``stream_bands()`` of the next job, no
    encoder), in turns (ABBA), so that both sides of each difference see
    the same state of the host. Host clock, per band."""
    from image_stitch_tpu_torch.core import TorchStreamingConcatenator

    from stitchbench.common.traffic import PAIRS

    def whole(job):
        rec, _ = run_job(program, cell, job, None)
        return None if rec.error else (rec.t_end - rec.t_call, rec.bands)

    def decode(job):
        t, bands = time.perf_counter(), 0
        for _ in TorchStreamingConcatenator(dict(cell.options, **job.options),
                                            device=device).stream_bands():
            bands += 1
        return time.perf_counter() - t, bands

    pairs = []
    for k in range(cell.traffic.params["layer_pairs"]):
        a = cell.traffic.job(seed, state, PAIRS + 2 * k)
        b = cell.traffic.job(seed, state, PAIRS + 2 * k + 1)
        if k % 2:
            d, w = decode(b), whole(a)
        else:
            w, d = whole(a), decode(b)
        pairs.append({"decode_s": d[0], "decode_bands": d[1],
                      "whole_s": None if w is None else w[0],
                      "whole_bands": None if w is None else w[1]})
    return pairs


def profiled_slice(program, cell, seed, state) -> dict:
    from stitchbench.common.measure import profile_slice
    from stitchbench.common.traffic import PROFILE
    from stitchbench.common.work import device_bytes

    n = cell.traffic.params["profile_jobs"]

    def jobs():
        return [run_job(program, cell, cell.traffic.job(seed, state, PROFILE + k), None)[0]
                for k in range(n)]

    prof = profile_slice(jobs)
    prof["device_bytes"] = sum(device_bytes(cell.options, r.spec, r.out_bytes)
                               for r in prof["jobs"])
    return prof


def check(cell, kept, pool) -> dict:
    """The numbers compared, over the kept jobs."""
    from stitchbench.reference import check as ref

    totals = {"jobs_checked": len(kept)}
    for _, out, spec, sized in kept:
        ref.combine(totals, ref.check(spec, cell.options, out, pool, sized))
    return totals


def rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float = T_START, program=None, workers: int | None = None) -> dict:
    """Set-up, window, traced passes and check of one run; the result
    object. ``program(options, counters)`` stands for the port's streaming
    entry (the tests hand a broken one in)."""
    from stitchbench.common.pool import Pool
    from stitchbench.common.traffic import WARMUP
    from stitchbench.reference.check import limits_hold

    port = load_port()
    from image_stitch_tpu_torch.ops.counters import EncodeCounters

    program = program or streaming_program(port, device)
    timing = {"import_s": time.perf_counter() - t_start}
    rss_mb = {"after_import": rss_bytes() / 1e6}
    t = time.perf_counter()
    with Pool(workers) as pool:
        state = cell.traffic.make_state(seed, pool)
    timing["tiles_s"] = time.perf_counter() - t
    rss_mb["after_tiles"] = rss_bytes() / 1e6
    t = time.perf_counter()
    for k in range(cell.traffic.params["warmup_jobs"]):
        rec, _ = run_job(program, cell, cell.traffic.job(seed, state, WARMUP + k), None)
        if rec.error:
            raise RunError(f"warm-up job failed: {rec.error}")
    timing["warmup_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    rss_mb["after_warmup"] = rss_bytes() / 1e6

    counters = EncodeCounters()
    records, draw, window_s, rss_peak, dev_peak = window(
        program, cell, seed, state, seconds, counters, device)
    data = Trace(cell, setup_s, records, window_s, rss_peak, dev_peak, vars(counters).copy())
    t = time.perf_counter()
    if trace:
        if device != "cpu":
            data.profile = profiled_slice(program, cell, seed, state)
        data.layer_pairs = layer_pairs(program, cell, seed, state, device)
    timing["trace_s"] = time.perf_counter() - t
    del state
    if device != "cpu":
        import torch

        torch.cuda.empty_cache()

    t = time.perf_counter()
    with Pool(workers) as pool:
        numbers = check(cell, draw.kept(), pool)
    timing["check_s"] = time.perf_counter() - t
    failed = sum(r.error is not None for r in records)
    numbers["jobs_failed"] = failed
    compared = limits_hold(numbers)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.reader()(data)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    result = {
        "correct": all(c["holds"] for c in compared.values()),
        "attempted": len(records),
        "failed": failed,
        "metrics": metrics,
        "device": device_info(device, cell.chips, dev_peak, data.profile if trace else None),
    }
    if trace and data.profile is not None:
        result["breakdown"] = {"device_ops": [list(x) for x in data.profile["device_ops"]],
                               "idle_gaps": [list(x) for x in data.profile["idle_gaps"]]}
    result["window"] = {"seconds": window_s, "jobs": len(records),
                        "job_s": [round(r.t_end - r.t_call, 4) for r in records],
                        "job_cpu_s": [round(r.cpu_s, 4) for r in records],
                        "errors": sorted({r.error for r in records if r.error})[:3],
                        "checked_jobs": [k[0] for k in draw.kept()],
                        "timing": timing, "rss_mb": rss_mb, "counters": data.counters}
    if data.layer_pairs:
        result["window"]["layer_pairs"] = data.layer_pairs
    if trace and data.profile is not None:
        p = data.profile
        result["window"]["profile"] = {k: p[k] for k in ("activities", "outside", "lead_kept",
                                                          "kernel_s", "device_bytes")}
    result["checks"] = compared
    return result


def device_info(device: str, chips: int, peak: int, profile: dict | None) -> dict:
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": peak, "power_limit_w": power_limit_w()}
    if profile is not None:
        info["busy_s"] = profile["busy_s"]
        info["window_s"] = profile["wall_s"]
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    prepare_environment()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    try:
        from stitchbench.common.manifest import Cell

        if not (ROOT / "BENCHMARK.json").is_file():
            raise RunError(f"no BENCHMARK.json in {ROOT}")
        cell = Cell.load(ROOT, args.workload)
        load_port()
        import torch

        if not torch.cuda.is_available():
            raise RunError("torch.cuda.is_available() is false: this benchmark runs on a CUDA card only")
        if torch.cuda.device_count() < cell.chips:
            raise RunError(f"{cell.name} needs {cell.chips} cards, {torch.cuda.device_count()} found")
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    except (RunError, KeyError, FileNotFoundError, ImportError) as e:
        print(f"stitchbench: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"stitchbench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']}, {c['is']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
