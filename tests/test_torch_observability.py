"""The torch port's ``device_trace`` (torch.profiler), mirroring
tests/unit/test_observability.py: a no-op without a directory; with one, a
Chrome trace of the region that names the port's functions. On the CPU the
trace holds Python stacks and host ops; on a card it also holds the kernels
(chip_smoke.py checks ``fdct_quant`` and ``pack_merge`` there)."""

import json

import numpy as np
import pytest
import torch

import image_stitch_tpu_torch as port
from image_stitch_tpu_torch.utils.observability import device_trace
from tests.utils.fixtures import png_from_array, random_rgba

torch.set_num_threads(1)


def trace_names(log_dir) -> set[str]:
    """The event names of the one trace file in ``log_dir``."""
    files = list(log_dir.glob("*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return {e.get("name", "") for e in json.load(f)["traceEvents"]}


def small_grid(fmt="jpeg"):
    tiles = [png_from_array(random_rgba(24, 16, s)) for s in range(4)]
    return {"inputs": tiles, "layout": {"columns": 2}, "outputFormat": fmt,
            "jpegRestartIntervalRows": 1}


def test_device_trace_noop_without_dir(monkeypatch, tmp_path):
    monkeypatch.delenv("STITCH_TPU_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with device_trace():
        x = 1 + 1
    assert x == 2
    assert not torch.autograd.profiler._is_profiler_enabled
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_device_trace_names_the_ports_functions(monkeypatch, tmp_path, how):
    """A small grid to JPEG on the CPU under the trace: the encoder's
    quantize and pack wrappers appear, by name, with their module."""
    if how == "environment":
        monkeypatch.setenv("STITCH_TPU_TRACE_DIR", str(tmp_path))
        region = device_trace()
    else:
        monkeypatch.delenv("STITCH_TPU_TRACE_DIR", raising=False)
        region = device_trace(tmp_path)
    with region:
        out = port.concat_to_buffer(small_grid(), device="cpu")
    assert out[:2] == b"\xff\xd8"
    names = trace_names(tmp_path)
    for fn in ("fdct_quant", "pack_merge"):
        assert any(n.startswith("image_stitch_tpu_torch/ops/kernels.py(") and n.endswith(
            f"): {fn}") for n in names), fn


def test_device_trace_of_the_host_tier(tmp_path):
    """The host tier under the trace: its encoder appears and no kernel
    wrapper does."""
    with device_trace(tmp_path):
        out = port.concat_to_buffer({**small_grid(), "backend": "numpy"})
    assert out[:2] == b"\xff\xd8"
    names = trace_names(tmp_path)
    assert any(n.endswith("): encode_band") and "codecs/jpeg/encoder.py" in n for n in names)
    assert not any("ops/kernels.py" in n for n in names)


def test_device_trace_writes_on_error(tmp_path):
    """A region that raises still leaves its trace, and the error passes."""
    with pytest.raises(ValueError):
        with device_trace(tmp_path):
            np.zeros(3).sum()
            raise ValueError("inside the region")
    assert trace_names(tmp_path)
