"""Compute backends for the band pipeline, and the "auto" policy.

A copy of ``image_stitch_tpu/ops/backend.py``. The orchestrator is
backend-agnostic: ``numpy`` (the host oracle: the C++ host library where it
builds, numpy otherwise; the bytes of the JAX package's ``backend="numpy"``)
and ``torch`` (``ops.device.TorchBackend``: the hand-written kernels on a
torch device). Both are bit-exact for everything the reference's grid mode
does (pure integer math), so the names choose a route, never the bytes.

"torch", and the JAX package's device names "jax" and "tpu", run on the
device; "numpy" and "oracle" on the host tier. "auto" is the JAX package's
policy: the host tier under ``AUTO_DEVICE_THRESHOLD_PIXELS``, above it a
per-band cost model over the measured host-device link
(``decide_auto_backend``, ``get_link_profile``). Its constants were
measured on an NVIDIA H100 by ``chip_smoke.py`` (PERF.md §6, the table
of the auto policy's constants); no TPU number is kept. The port's entry points default to "torch", so the
policy runs only where a caller asks for "auto".
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..errors import StitchError
from .counters import EncodeCounters
from .device import TorchBackend
from .pixel import band_to_bytes
from .png_filter import filter_select_band
from .resolve import resolve_device


class NumpyBackend:
    """Host-side oracle backend. The async API is the sync one (compute on
    submit, identity on wait) so the orchestrator has one pipeline shape."""

    name = "numpy"

    def png_filter_band(
        self, canvas: np.ndarray, prev_row: np.ndarray | None
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Filter-select a canvas band.

        ``canvas``: (H, W, 4) uint8/uint16. ``prev_row``: previous *raw* row
        bytes (W*bpp,) or None. Returns (filter_types (H,), filtered rows
        (H, W*bpp), last raw row (W*bpp,)) — the carry for the next band.
        """
        bpp = 8 if canvas.dtype == np.uint16 else 4
        raw = band_to_bytes(canvas)
        from ..native import filter_select_band_native

        native = filter_select_band_native(raw, prev_row, bpp)
        if native is not None:
            types, filtered = native
        else:
            types, filtered = filter_select_band(raw, prev_row, bpp)
        return types, filtered, raw[-1]

    def png_filter_band_async(self, canvas, prev_row):
        return self.png_filter_band(canvas, prev_row)

    @staticmethod
    def png_filter_band_wait(pending):
        return pending


_NUMPY_BACKEND = NumpyBackend()

# The cost model's constants, each measured by chip_smoke.py's policy phase
# (phase 6) on an NVIDIA H100 80GB HBM3 at 700.00 W (nvidia-smi name,
# power.limit) in three runs of the script, each its own call; PERF.md §6,
# the table of the auto policy's constants, row by row.
#
# Below this many canvas pixels "auto" takes the host tier: the smallest
# power of two from which the card's median rate, on 2 x 2 grids of PNG
# tiles to JPEG q85 with restart rows 1, is no more than one spread below
# the host tier's at that size and every larger one of the sweep (0.066 to
# 16.8 MP, five runs of each tier in turns), in every call: the three
# sweeps gave 2^16, 2^22 and 2^18.
AUTO_DEVICE_THRESHOLD_PIXELS = 1 << 22
# The host tier's end-to-end rate: the median of its phase 5 grid_jpeg runs
# (an 8 x 8 grid of 1024^2 PNG tiles, 67.1 MP, to JPEG q85 with restart
# rows 1): 31.10, 28.47; 26.80, 27.23; 20.88, 20.92 MP/s.
HOST_NATIVE_RATE_MPS = 27.02
# The card's marginal rate once a band is resident: 256 x 8192 pixels over
# the band program's time between CUDA events (fdct_quant, symbol_streams,
# group_layout, the memset and pack_merge on a real grid_jpeg band), the
# median of 0.1345, 0.1446 and 0.2781 ms, launch costs included, as the JAX
# package's constant is a pipelined rate.
DEVICE_COMPUTE_RATE_MPS = 14503.0
# Bytes a pixel of the band's result brings back over d2h: grid_jpeg's
# 16,865,654 output bytes over its 67,108,864 pixels (every run).
FETCH_BYTES_PER_PX = 0.2513
# Link round trips a band (the port's own count, not a measurement): one
# pinned upload, the band program's launches, one read-back (ops/
# jpeg_entropy_device.py: TorchJpegEncoder.submit and wait).
LINK_ROUND_TRIPS_PER_BAND = 3
# The planning band: 256 rows of about 10k pixels (a size, not a
# measurement).
_MODEL_BAND_PIXELS = 2_500_000


@dataclass
class LinkProfile:
    """Measured host<->device link characteristics."""

    h2d_mbps: float
    latency_ms: float
    d2h_mbps: float | None = None  # None: unknown (ignore the d2h term)
    # True when this is the blown-probe-budget sentinel, not a measurement.
    # Sentinels stay session-local (never persisted): one slow window must
    # not pin "auto" to the host for every future session.
    timed_out: bool = False
    # Where the measurement was taken: "cuda <card name>" or "cpu". The
    # persistent cache is keyed by it, so another card is probed anew.
    platform: str | None = None


def decide_auto_backend(
    canvas_pixels: int, native_ok: bool, profile: LinkProfile | None
) -> str:
    """Pure policy: device vs host from a simple per-band cost model.

    Device band time = upload (4 B/px, an RGBA band, over the h2d rate) +
    round-trip latencies + on-device compute + the result's fetch over d2h;
    host band time = the host tier's rate. The JAX package's branches in its
    order; "torch" where it answers "jax".
    """
    if canvas_pixels < AUTO_DEVICE_THRESHOLD_PIXELS:
        return "numpy"
    if not native_ok:
        return "torch"  # no host fast tier; the device wins regardless of link
    if profile is None:
        return "numpy"  # unknown link: the exact host tier is the safe default
    band_px = min(_MODEL_BAND_PIXELS, canvas_pixels)
    upload_s = band_px * 4 / (profile.h2d_mbps * 1e6)
    overhead_s = LINK_ROUND_TRIPS_PER_BAND * profile.latency_ms / 1e3
    compute_s = band_px / (DEVICE_COMPUTE_RATE_MPS * 1e6)
    fetch_s = 0.0
    if profile.d2h_mbps:
        fetch_s = band_px * FETCH_BYTES_PER_PX / (profile.d2h_mbps * 1e6)
    device_rate = band_px / (upload_s + overhead_s + compute_s + fetch_s)
    return "torch" if device_rate > HOST_NATIVE_RATE_MPS * 1e6 else "numpy"


# The profiles probed in this process, by platform (a timed-out sentinel
# included).
_LINK_PROFILES: dict[str, LinkProfile | None] = {}

# The probe child: the port's own module, never the JAX package's.
_PROBE_CHILD = (
    "import json\n"
    "from image_stitch_tpu_torch.ops.backend import _probe_link_blocking\n"
    "p = _probe_link_blocking({device!r})\n"
    "print(json.dumps(None if p is None else "
    "[p.h2d_mbps, p.latency_ms, p.d2h_mbps, p.platform]))\n"
)


def _platform(device: torch.device) -> str:
    """"cuda <card name>" for a CUDA device, else its type."""
    if device.type == "cuda":
        return f"cuda {torch.cuda.get_device_name(device)}"
    return device.type


def _link_profile_cache_path() -> str:
    return os.path.join(
        os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache")),
        "image_stitch_tpu_torch",
        "link_profile.json",
    )


def _save_link_profile(profile: LinkProfile) -> None:
    platform = profile.platform
    if platform is None or platform == "cpu":
        return
    path = _link_profile_cache_path()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(
                {
                    "v": 2,
                    "platform": platform,
                    "h2d_mbps": profile.h2d_mbps,
                    "latency_ms": profile.latency_ms,
                    "d2h_mbps": profile.d2h_mbps,
                },
                f,
            )
    except OSError:
        pass


def _probe_link_blocking(device="cuda") -> LinkProfile | None:
    """Measure h2d/d2h bandwidth and latency with two-point transfer fits.

    Pinned 1 MiB and 8 MiB host tensors are uploaded with
    ``.to(device, non_blocking=True)``; each upload is completed by reading
    a 16-byte reduction back, since an acknowledged copy is not proof that
    the bytes crossed the link. Each point is the least of three. An 8 MiB
    read-back gives d2h. A CPU device has no link: it is modelled as
    instant.
    """
    try:
        dev = torch.device(device)
        if dev.type == "cpu":
            return LinkProfile(h2d_mbps=1e6, latency_ms=0.0, d2h_mbps=1e6,
                               platform="cpu")
        small = torch.zeros(1 << 20, dtype=torch.uint8).pin_memory()
        big = torch.zeros(1 << 23, dtype=torch.uint8).pin_memory()

        def upload_roundtrip(buf: torch.Tensor) -> float:
            t0 = time.perf_counter()
            x = buf.to(dev, non_blocking=True)
            x[:16].sum().item()
            return time.perf_counter() - t0

        upload_roundtrip(small)  # warm-up: context, allocator, kernels
        t_small = min(upload_roundtrip(small) for _ in range(3))
        t_big = min(upload_roundtrip(big) for _ in range(3))
        n_small, n_big = small.numel(), big.numel()
        bw = (n_big - n_small) / max(t_big - t_small, 1e-9) / 1e6
        latency = max(0.0, t_small - n_small / (bw * 1e6)) * 1e3
        x = big.to(dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        x.cpu()
        d2h = n_big / max(time.perf_counter() - t0, 1e-9) / 1e6
        return LinkProfile(h2d_mbps=bw, latency_ms=latency, d2h_mbps=d2h,
                           platform=_platform(dev))
    except Exception:
        return None


def probe_link_profile(device="cuda") -> LinkProfile | None:
    """Run the blocking probe under a hard wall-clock budget.

    The budget (STITCH_TPU_PROBE_BUDGET_S, default 45 s, the JAX
    package's) bounds what the probe may charge to the caller's first
    stream; a blown budget is itself the measurement, a slow-link verdict
    that no cost model maps to the device. The probe runs in a kill-safe
    child process, which a healthy link finishes in a few seconds,
    interpreter and CUDA start included. A CPU device is probed in-process
    (instantly).
    """
    dev = torch.device(device)
    if dev.type == "cpu":
        return _probe_link_blocking(dev)
    budget_s = float(os.environ.get("STITCH_TPU_PROBE_BUDGET_S", "45"))
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    try:
        out = subprocess.run(
            [sys.executable, "-c", _PROBE_CHILD.format(device=str(dev))],
            capture_output=True, text=True, timeout=budget_s, env=env,
        )
    except subprocess.TimeoutExpired:
        # Conservative slow-link verdict: vetoes the device in every model.
        # Session-local only (timed_out): a later session probes again.
        return LinkProfile(
            h2d_mbps=0.01, latency_ms=budget_s * 1e3, d2h_mbps=0.01,
            timed_out=True,
        )
    except OSError:
        # No subprocess capability: the in-process probe, with no budget,
        # rather than no information.
        return _probe_link_blocking(dev)
    try:
        vals = json.loads(out.stdout.strip().splitlines()[-1])
    except Exception:
        # Child crashed or printed garbage: "no profile". The unbudgeted
        # in-process probe is not run in its place.
        return None
    if vals is None:
        return None
    return LinkProfile(
        h2d_mbps=vals[0], latency_ms=vals[1], d2h_mbps=vals[2],
        platform=vals[3] if len(vals) > 3 else None,
    )


def get_link_profile(device="cuda") -> LinkProfile | None:
    """Env override (STITCH_TPU_LINK_PROFILE="h2d_mbps,latency_ms") ->
    persistent cache -> one probe, once per session and platform."""
    dev = torch.device(device)
    platform = _platform(dev)
    if platform in _LINK_PROFILES:
        return _LINK_PROFILES[platform]
    override = os.environ.get("STITCH_TPU_LINK_PROFILE")
    if override:
        try:
            bw, lat = (float(x) for x in override.split(","))
            _LINK_PROFILES[platform] = LinkProfile(h2d_mbps=bw, latency_ms=lat)
            return _LINK_PROFILES[platform]
        except ValueError:
            pass
    try:
        with open(_link_profile_cache_path()) as f:
            d = json.load(f)
        # Sentinel-grade entries (no real link measures < 1 MB/s) are never
        # trusted from disk: probe again instead.
        if d.get("platform") == platform and d.get("v") == 2 and d["h2d_mbps"] >= 1.0:
            _LINK_PROFILES[platform] = LinkProfile(
                d["h2d_mbps"], d["latency_ms"], d.get("d2h_mbps"), platform=platform,
            )
            return _LINK_PROFILES[platform]
    except Exception:
        pass
    profile = probe_link_profile(dev)
    _LINK_PROFILES[platform] = profile
    if profile is not None and not profile.timed_out:
        _save_link_profile(profile)
    return profile


def resolve_backend_name(name: str, canvas_pixels: int | None = None,
                         device=None) -> str:
    """Map option strings to a concrete backend: "oracle" and "numpy" ->
    "numpy"; "torch", "jax" and "tpu" -> "torch" (force the device); any
    other name but "auto" raises.

    "auto": the host tier for canvases under AUTO_DEVICE_THRESHOLD_PIXELS
    (or of unknown size); then STITCH_TPU_PREFER_DEVICE=1/0 overrides; then
    the device if the C++ host library is missing; else the cost model
    (``decide_auto_backend``) over the link to ``device`` (default "cuda"),
    which is resolved first, so a missing card raises before any probe.
    """
    key = {"oracle": "numpy", "tpu": "torch", "jax": "torch"}.get(name, name)
    if key == "auto":
        big = (
            canvas_pixels is not None
            and canvas_pixels >= AUTO_DEVICE_THRESHOLD_PIXELS
        )
        if not big:
            return "numpy"
        pref = os.environ.get("STITCH_TPU_PREFER_DEVICE")
        if pref == "1":
            return "torch"
        if pref == "0":
            return "numpy"
        from ..native import native_available

        native_ok = native_available()
        if not native_ok:
            return "torch"
        dev = resolve_device("cuda" if device is None else device)
        return decide_auto_backend(canvas_pixels, native_ok, get_link_profile(dev))
    if key not in ("numpy", "torch"):
        raise StitchError(
            f"backend={name!r} is not a path of image_stitch_tpu_torch; "
            "use 'torch', 'numpy' or 'auto'"
        )
    return key


def get_backend(name: str, device=None, counters: EncodeCounters | None = None,
                canvas_pixels: int | None = None):
    """'oracle'/'numpy' -> the shared NumpyBackend; 'torch'/'jax'/'tpu' ->
    TorchBackend(device, counters); 'auto' -> the policy's choice for
    ``canvas_pixels``."""
    if resolve_backend_name(name, canvas_pixels, device) == "numpy":
        return _NUMPY_BACKEND
    return TorchBackend(device, counters)
