"""The torch port's "auto" backend policy against the JAX package's.

(a) The 15 cases of tests/unit/test_backend_policy.py, with the same
inputs, on ``image_stitch_tpu_torch.ops.backend``; where a case depends on
a constant, the JAX package's constants are patched into the port's
module. "jax" in the JAX package's answers reads "torch".
(b) Parity: with the same constants, ``decide_auto_backend`` gives the JAX
package's answer over a grid of canvas sizes, ``native_ok`` both ways and
five link profiles, one test a case.
(c) End to end on the CPU: "auto" under and over the threshold gives the
JAX package's bytes (its own "auto"), on the host tier under it and the
torch tier over it; "jax"/"tpu" equal "torch"; the default runs the torch
tier at every size; the device is resolved only for a "torch" answer.
(d) The probe: the env override, the timeout sentinel (session-local, never
persisted), a stale persisted sentinel re-probed, a crashed child, the CPU
probe in-process, a persisted profile read back without a second probe.
(e) The constants lie inside the H100 bands that PERF.md §6 records.
"""

import json

import numpy as np
import pytest
import torch

import image_stitch_tpu
import image_stitch_tpu.types
from image_stitch_tpu.ops import backend as J
import image_stitch_tpu_torch as port
from image_stitch_tpu_torch.codecs.jpeg.encoder import StreamingJpegEncoder
from image_stitch_tpu_torch.native import native_available
from image_stitch_tpu_torch.ops import backend as B
from image_stitch_tpu_torch.types import PositionedImage
from tests.utils.fixtures import png_from_array

torch.set_num_threads(1)

# The JAX package's cost model, with its fetch's 0.19 B/px
# (image_stitch_tpu/ops/backend.py:125, a literal there).
JAX_CONSTANTS = {
    "AUTO_DEVICE_THRESHOLD_PIXELS": J.AUTO_DEVICE_THRESHOLD_PIXELS,
    "HOST_NATIVE_RATE_MPS": J.HOST_NATIVE_RATE_MPS,
    "DEVICE_COMPUTE_RATE_MPS": J.DEVICE_COMPUTE_RATE_MPS,
    "LINK_ROUND_TRIPS_PER_BAND": J.LINK_ROUND_TRIPS_PER_BAND,
    "_MODEL_BAND_PIXELS": J._MODEL_BAND_PIXELS,
    "FETCH_BYTES_PER_PX": 0.19,
}


@pytest.fixture
def session(monkeypatch, tmp_path):
    """A fresh session: no profile probed yet, no policy variable set, and
    an empty persistent cache."""
    monkeypatch.setattr(B, "_LINK_PROFILES", {})
    for var in ("STITCH_TPU_PREFER_DEVICE", "STITCH_TPU_LINK_PROFILE",
                "STITCH_TPU_PROBE_BUDGET_S"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    return tmp_path


@pytest.fixture
def jax_constants(monkeypatch):
    for name, value in JAX_CONSTANTS.items():
        monkeypatch.setattr(B, name, value)


def refuse(*args, **kwargs):
    raise AssertionError("must not run")


# --------------------------------------------------------------------------- #
# (a) The JAX package's cases
# --------------------------------------------------------------------------- #


def test_small_canvas_always_host(jax_constants):
    assert B.decide_auto_backend(1 << 18, True, B.LinkProfile(1e5, 0.01)) == "numpy"


def test_no_native_tier_picks_device(jax_constants):
    assert B.decide_auto_backend(1 << 24, False, None) == "torch"


def test_unknown_link_defaults_to_host(jax_constants):
    assert B.decide_auto_backend(1 << 24, True, None) == "numpy"


def test_pcie_class_link_picks_device(jax_constants):
    assert B.decide_auto_backend(1 << 24, True, B.LinkProfile(10000, 0.1)) == "torch"


def test_tunneled_link_picks_host(jax_constants):
    assert B.decide_auto_backend(1 << 24, True, B.LinkProfile(114, 25)) == "numpy"


def test_env_profile_override(session, jax_constants, monkeypatch):
    monkeypatch.setenv("STITCH_TPU_LINK_PROFILE", "10000,0.1")
    monkeypatch.setattr(B, "probe_link_profile", refuse)
    prof = B.get_link_profile("cpu")
    assert prof.h2d_mbps == 10000 and prof.latency_ms == 0.1
    if native_available():
        assert B.resolve_backend_name("auto", 1 << 24, "cpu") == "torch"


def test_prefer_device_env_overrides(session, jax_constants, monkeypatch):
    monkeypatch.setattr(B, "get_link_profile", refuse)
    monkeypatch.setenv("STITCH_TPU_PREFER_DEVICE", "0")
    assert B.resolve_backend_name("auto", 1 << 24) == "numpy"
    monkeypatch.setenv("STITCH_TPU_PREFER_DEVICE", "1")
    assert B.resolve_backend_name("auto", 1 << 24) == "torch"
    # Read after the threshold, as in the JAX package: a small canvas stays
    # on the host tier.
    assert B.resolve_backend_name("auto", 1 << 18) == "numpy"


def test_explicit_names_resolve():
    assert B.resolve_backend_name("oracle") == "numpy"
    assert B.resolve_backend_name("tpu") == "torch"
    assert B.resolve_backend_name("numpy") == "numpy"


def test_slow_d2h_picks_host_despite_fast_upload(jax_constants):
    prof = B.LinkProfile(h2d_mbps=10000, latency_ms=0.1, d2h_mbps=0.5)
    assert B.decide_auto_backend(1 << 24, True, prof) == "numpy"
    fast = B.LinkProfile(h2d_mbps=10000, latency_ms=0.1, d2h_mbps=5000)
    assert B.decide_auto_backend(1 << 24, True, fast) == "torch"


def timeout_run(*args, **kwargs):
    import subprocess

    raise subprocess.TimeoutExpired(cmd="probe", timeout=kwargs.get("timeout"))


def test_probe_timeout_yields_slow_link_verdict(monkeypatch):
    import subprocess

    monkeypatch.setattr(subprocess, "run", timeout_run)
    prof = B.probe_link_profile("cuda")  # a CUDA device: the child process
    assert prof is not None and prof.timed_out
    assert prof.h2d_mbps < 1.0
    assert B.decide_auto_backend(1 << 26, True, prof) == "numpy"


def test_device_rate_constant_is_measured():
    """The card's band program between CUDA events, 256 x 8192 px over
    0.2322-0.2699 ms in earlier runs and 0.1345-0.2781 ms in the three runs
    the constant comes from (NVIDIA H100 80GB HBM3, 700 W; PERF.md §5, §6):
    7,540-15,596 MP/s, never an aspirational number."""
    assert 7540 <= B.DEVICE_COMPUTE_RATE_MPS <= 15600


def test_host_rate_constant_is_measured():
    """The host tier's grid_jpeg 67.1 MP runs: 23.83-26.01 MP/s in earlier
    runs, 20.88-31.10 in the three runs whose median the constant is
    (PERF.md §5, §6)."""
    assert 20.8 <= B.HOST_NATIVE_RATE_MPS <= 31.1


def test_probe_timeout_sentinel_stays_session_local(session, monkeypatch):
    import subprocess

    monkeypatch.setattr(subprocess, "run", timeout_run)
    prof = B.probe_link_profile("cuda")
    assert prof.timed_out
    saved = []
    monkeypatch.setattr(B, "_save_link_profile", lambda p: saved.append(p))
    monkeypatch.setattr(B, "probe_link_profile", lambda device: prof)
    monkeypatch.setattr(B, "_platform", lambda device: "cuda NVIDIA H100 80GB HBM3")
    assert B.get_link_profile("cuda") is prof
    assert saved == []
    assert not (session / "image_stitch_tpu_torch").exists()
    assert B.get_link_profile("cuda") is prof  # session-local: no second probe


def test_stale_persisted_sentinel_is_reprobed(session, monkeypatch):
    cache_dir = session / "image_stitch_tpu_torch"
    cache_dir.mkdir()
    (cache_dir / "link_profile.json").write_text(json.dumps({
        "v": 2, "platform": "cpu",
        "h2d_mbps": 0.01, "latency_ms": 20000.0, "d2h_mbps": 0.01,
    }))
    fresh = B.LinkProfile(h2d_mbps=500.0, latency_ms=1.0, d2h_mbps=500.0)
    monkeypatch.setattr(B, "probe_link_profile", lambda device: fresh)
    assert B.get_link_profile("cpu") is fresh


def test_probe_child_crash_returns_none_not_blocking(monkeypatch):
    import subprocess

    class Out:
        stdout = "Traceback (most recent call last):\nBoom\n"

    monkeypatch.setattr(subprocess, "run", lambda *a, **k: Out())
    monkeypatch.setattr(B, "_probe_link_blocking", refuse)
    assert B.probe_link_profile("cuda") is None


# --------------------------------------------------------------------------- #
# (b) Parity with the JAX package's decisions
# --------------------------------------------------------------------------- #

PROFILES = {
    "none": None,
    "pcie": J.LinkProfile(h2d_mbps=10000, latency_ms=0.1, d2h_mbps=10000),
    "tunnel": J.LinkProfile(h2d_mbps=114, latency_ms=25),
    "slow_d2h": J.LinkProfile(h2d_mbps=10000, latency_ms=0.1, d2h_mbps=0.5),
    "timed_out": J.LinkProfile(h2d_mbps=0.01, latency_ms=45e3, d2h_mbps=0.01,
                               timed_out=True),
}
SIZES = [0, 1, 1 << 18, (1 << 21) - 1, 1 << 21, 2_500_000, 1 << 22, 1 << 24, 1 << 26]


@pytest.mark.parametrize("profile", list(PROFILES))
@pytest.mark.parametrize("native_ok", [True, False])
@pytest.mark.parametrize("pixels", SIZES)
def test_decision_equals_the_jax_package(jax_constants, pixels, native_ok, profile):
    jp = PROFILES[profile]
    pp = None if jp is None else B.LinkProfile(jp.h2d_mbps, jp.latency_ms, jp.d2h_mbps,
                                               timed_out=jp.timed_out)
    want = J.decide_auto_backend(pixels, native_ok, jp)
    got = B.decide_auto_backend(pixels, native_ok, pp)
    assert got == {"jax": "torch"}.get(want, want)


# --------------------------------------------------------------------------- #
# (c) End to end on the CPU
# --------------------------------------------------------------------------- #

THRESHOLD = 1 << 12  # patched in: the CPU tests keep their canvases small


def photo(h, w, seed):
    rng = np.random.default_rng(seed)
    img = np.empty((h, w, 4), np.uint8)
    img[..., 0] = np.linspace(0, 255, w, dtype=np.float32)[None, :].astype(np.uint8)
    img[..., 1] = rng.integers(0, 256, (h, w), dtype=np.uint8)
    img[..., 2] = np.linspace(0, 255, h, dtype=np.float32)[:, None].astype(np.uint8)
    img[..., 3] = 255
    return img


def grid(w, h, fmt):
    """A 2 x 2 grid of w x h tiles: 4 * w * h canvas pixels."""
    tiles = [png_from_array(photo(h, w, s)) for s in range(4)]
    return {"inputs": tiles, "layout": {"columns": 2}, "outputFormat": fmt,
            "bandHeight": 16, "jpegRestartIntervalRows": 1}


def positioned(side):
    """A side x side canvas under two overlapping, partly transparent
    images."""
    a, b = photo(side // 2, side // 2, 7), photo(side // 2, side // 3, 8)
    b[..., 3] = 120
    return {"inputs": [PositionedImage(0, 0, png_from_array(a)),
                       PositionedImage(side // 4, side // 3, png_from_array(b))],
            "layout": {"width": side, "height": side}, "outputFormat": "png",
            "bandHeight": 16}


def jax_auto(opts):
    """The JAX package's own "auto" on ``opts`` (its host tier at these
    sizes), the port's PositionedImage inputs given as that package's."""
    inputs = [image_stitch_tpu.types.PositionedImage(i.x, i.y, i.source)
              if isinstance(i, PositionedImage) else i for i in opts["inputs"]]
    return image_stitch_tpu.concat_to_buffer({**opts, "inputs": inputs, "backend": "auto"})


CASES = {
    "grid_jpeg": (lambda: grid(24, 16, "jpeg"), lambda: grid(48, 40, "jpeg")),
    "grid_png": (lambda: grid(24, 16, "png"), lambda: grid(48, 40, "png")),
    "positioned_png": (lambda: positioned(48), lambda: positioned(96)),
}


@pytest.mark.parametrize("over", [False, True], ids=["under", "over"])
@pytest.mark.parametrize("case", list(CASES))
def test_auto_routes_by_canvas_size(session, monkeypatch, case, over):
    """Under the threshold the host tier codes every band and launches
    nothing; over it (the CPU's instant link, or no C++ host library) the
    torch tier does. The bytes are the JAX package's either way."""
    monkeypatch.setattr(B, "AUTO_DEVICE_THRESHOLD_PIXELS", THRESHOLD)
    opts = CASES[case][over]()
    counters = port.EncodeCounters()
    got = port.concat_to_buffer({**opts, "backend": "auto"}, device="cpu", counters=counters)
    assert got == jax_auto(opts)
    torch_bands = counters.bands + counters.png_bands
    if over:
        assert torch_bands > 0 and counters.host_tier_bands == 0
    else:
        assert torch_bands == 0 and counters.host_tier_bands > 0


@pytest.mark.parametrize("name", ["jax", "tpu"])
@pytest.mark.parametrize("case", list(CASES))
def test_device_names_equal_torch(case, name):
    opts = CASES[case][0]()
    counters = port.EncodeCounters()
    got = port.concat_to_buffer({**opts, "backend": name}, device="cpu", counters=counters)
    assert got == port.concat_to_buffer({**opts, "backend": "torch"}, device="cpu")
    assert counters.host_tier_bands == 0 and counters.bands + counters.png_bands > 0


@pytest.mark.parametrize("threshold", [1, 1 << 40], ids=["every_size_over", "every_size_under"])
def test_default_runs_the_torch_tier_at_every_size(session, monkeypatch, threshold):
    """The port's rule: its entry points run on ``device`` unless the caller
    asks otherwise; the default is "torch", whatever the policy would say."""
    monkeypatch.setattr(B, "AUTO_DEVICE_THRESHOLD_PIXELS", threshold)
    monkeypatch.setattr(B, "get_link_profile", refuse)
    assert port.ConcatOptions(inputs=[]).backend == "torch"
    for make in CASES["grid_jpeg"]:
        opts = make()
        counters = port.EncodeCounters()
        got = port.concat_to_buffer(opts, device="cpu", counters=counters)
        assert got == jax_auto(opts)
        assert counters.bands > 0 and counters.host_tier_bands == 0


def test_auto_under_the_threshold_reads_no_device(session, monkeypatch):
    """"auto" under the threshold takes the host tier without resolving
    ``device``: the default "cuda" works without a card. Over it, a missing
    card raises before any probe."""
    monkeypatch.setattr(B, "AUTO_DEVICE_THRESHOLD_PIXELS", THRESHOLD)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(B, "probe_link_profile", refuse)
    small, big = grid(24, 16, "jpeg"), grid(48, 40, "jpeg")
    core = port.TorchStreamingConcatenator({**small, "backend": "auto"})
    assert core.device is None
    assert b"".join(core.stream()) == jax_auto(small)
    assert core.backend == "numpy" and core.device is None
    import image_stitch_tpu_torch.native as native

    monkeypatch.setattr(native, "native_available", lambda: True)
    with pytest.raises(port.StitchError, match="CUDA"):
        port.concat_to_buffer({**big, "backend": "auto"})


def test_auto_under_a_mesh_takes_the_mesh(session, monkeypatch):
    """A mesh takes the band programs whatever ``backend`` says, "auto" under
    the threshold included, as in the JAX package."""
    monkeypatch.setattr(B, "get_link_profile", refuse)
    opts = grid(24, 16, "jpeg")
    counters = port.EncodeCounters()
    got = port.concat_to_buffer({**opts, "backend": "auto", "mesh": 2}, device="cpu",
                                counters=counters)
    assert got == jax_auto(opts)
    assert counters.mesh_dispatches > 0 and counters.host_tier_bands == 0


@pytest.mark.parametrize("over", [False, True], ids=["under", "over"])
def test_jpeg_encoder_auto_follows_the_policy(session, monkeypatch, over):
    """``JpegEncoder(..., "auto")`` resolves with width * height: the host
    tier under the threshold, the torch tier over it; where the JAX
    package's encoder codes "auto" on the host. Same bytes."""
    monkeypatch.setattr(B, "AUTO_DEVICE_THRESHOLD_PIXELS", THRESHOLD)
    w, h = (96, 80) if over else (24, 16)
    rgba = photo(h, w, 3)
    counters = port.EncodeCounters()
    enc = port.JpegEncoder(w, h, 85, "auto", device="cpu", counters=counters)
    assert isinstance(enc._inner, port.TorchStreamingJpegEncoder if over
                      else StreamingJpegEncoder)
    want = image_stitch_tpu.encode_jpeg(rgba, w, h, 85, "auto")
    assert enc.encode_to_buffer(rgba.tobytes()) == want
    assert port.encode_jpeg(rgba, w, h, 85, "auto", device="cpu") == want
    assert (counters.bands > 0) == over and (counters.host_tier_bands > 0) != over


# --------------------------------------------------------------------------- #
# (d) The probe and its cache
# --------------------------------------------------------------------------- #


def test_cpu_probe_is_in_process_and_instant(session, monkeypatch):
    import subprocess

    monkeypatch.setattr(subprocess, "run", refuse)
    prof = B.probe_link_profile("cpu")
    assert (prof.h2d_mbps, prof.latency_ms, prof.d2h_mbps, prof.platform) == (
        1e6, 0.0, 1e6, "cpu")
    assert B.get_link_profile("cpu") == prof
    assert not (session / "image_stitch_tpu_torch").exists()  # cpu is never persisted


def test_probe_child_runs_the_ports_module(monkeypatch):
    """The child gets the port's module on PYTHONPATH, the device as a
    string and the budget as its timeout; its JSON line is the profile."""
    import subprocess

    seen = {}

    class Out:
        stdout = "noise\n[36000.5, 0.02, 21000.0, \"cuda NVIDIA H100 80GB HBM3\"]\n"

    def run(cmd, **kwargs):
        seen.update(cmd=cmd, **kwargs)
        return Out()

    monkeypatch.setattr(subprocess, "run", run)
    monkeypatch.setenv("STITCH_TPU_PROBE_BUDGET_S", "7.5")
    prof = B.probe_link_profile("cuda:0")
    assert prof == B.LinkProfile(36000.5, 0.02, 21000.0,
                                 platform="cuda NVIDIA H100 80GB HBM3")
    code = seen["cmd"][-1]
    assert "from image_stitch_tpu_torch.ops.backend import _probe_link_blocking" in code
    assert "_probe_link_blocking('cuda:0')" in code
    assert seen["timeout"] == 7.5
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert seen["env"]["PYTHONPATH"].split(os.pathsep)[0] == root


def test_persisted_profile_is_read_back_without_a_second_probe(session, monkeypatch):
    card = "cuda NVIDIA H100 80GB HBM3"
    measured = B.LinkProfile(36000.0, 0.02, 21000.0, platform=card)
    monkeypatch.setattr(B, "_platform", lambda device: card)
    monkeypatch.setattr(B, "probe_link_profile", lambda device: measured)
    assert B.get_link_profile("cuda") is measured
    path = session / "image_stitch_tpu_torch" / "link_profile.json"
    assert json.loads(path.read_text())["platform"] == card
    monkeypatch.setattr(B, "_LINK_PROFILES", {})  # a new session
    monkeypatch.setattr(B, "probe_link_profile", refuse)
    assert B.get_link_profile("cuda") == measured
    # Another card's profile is not read: it is probed anew.
    monkeypatch.setattr(B, "_LINK_PROFILES", {})
    monkeypatch.setattr(B, "_platform", lambda device: "cuda NVIDIA A100-SXM4-80GB")
    other = B.LinkProfile(20000.0, 0.03, 15000.0, platform="cuda NVIDIA A100-SXM4-80GB")
    monkeypatch.setattr(B, "probe_link_profile", lambda device: other)
    assert B.get_link_profile("cuda") is other


# --------------------------------------------------------------------------- #
# (e) The H100 constants
# --------------------------------------------------------------------------- #


def test_fetch_constant_is_measured():
    """grid_jpeg's output bytes over its pixels, 16,865,654 B for 67.1 MP
    in every run (PERF.md §6): 0.2513 B/px, where the JAX package has 0.19."""
    assert 0.24 <= B.FETCH_BYTES_PER_PX <= 0.26


def test_threshold_constant_is_from_the_sweep():
    """A power of two from the sweep of 2 x 2 grids, 2^16 to 2^24 canvas
    pixels, or the one above the sweep's largest (PERF.md §6: 2^16, 2^22
    and 2^18 in three runs, and 2^22 for all three)."""
    t = B.AUTO_DEVICE_THRESHOLD_PIXELS
    assert t & (t - 1) == 0 and (1 << 16) <= t <= (1 << 25)


def test_model_band_and_round_trips_are_the_ports():
    assert B.LINK_ROUND_TRIPS_PER_BAND == 3
    assert B._MODEL_BAND_PIXELS == 2_500_000
