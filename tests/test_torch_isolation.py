"""The torch port stands alone: it imports nothing of ``image_stitch_tpu``.

(a) Every ``.py`` file of ``image_stitch_tpu_torch/`` and ``chip_smoke.py``,
parsed with ``ast``, has no ``import image_stitch_tpu...`` and no ``from
image_stitch_tpu... import``; relative imports stay inside the port.
(b) A fresh process imports every module of the port and runs
``concat_to_buffer(..., device="cpu")`` to JPEG and to PNG on a 2 x 2 grid,
and a 2 x 2 grid of JPEG tiles (made by the port's encoder) to JPEG
through the device-decode path, the sharded dual step
(``parallel.mesh.run_multichip_demo``) and both grids over a mesh of 4
virtual CPU shards, then the command line (``main`` of
``image_stitch_tpu_torch/__main__.py``) over tile files with ``--device
cpu``, also with ``--mesh 2``; afterwards no module of ``image_stitch_tpu``
and no ``jax`` is loaded.
(c) The code that the link probe runs in its child process imports only
the port's module, and loads neither package when it runs.
"""

import ast
import glob
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "image_stitch_tpu_torch"
FILES = sorted(
    os.path.relpath(p, REPO)
    for p in glob.glob(os.path.join(REPO, PORT, "**", "*.py"), recursive=True)
) + ["chip_smoke.py"]


def _foreign(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("image_stitch_tpu", "jax")


@pytest.mark.parametrize("rel", FILES)
def test_file_imports_nothing_of_the_jax_package(rel):
    with open(os.path.join(REPO, rel)) as f:
        tree = ast.parse(f.read(), filename=rel)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _foreign(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _foreign(node.module):
                found.append(node.module)
    assert not found, f"{rel} imports {found}"


def test_port_files_are_listed():
    """The parametrisation above covers the whole package, copies included."""
    for rel in ("image_stitch_tpu_torch/core.py", "image_stitch_tpu_torch/api.py",
                "image_stitch_tpu_torch/__main__.py", "image_stitch_tpu_torch/__init__.py",
                "image_stitch_tpu_torch/codecs/jpeg/encoder.py",
                "image_stitch_tpu_torch/native/__init__.py",
                "image_stitch_tpu_torch/codecs/png/decoder.py",
                "image_stitch_tpu_torch/codecs/jpeg/owned_decoder.py",
                "image_stitch_tpu_torch/parallel/mesh.py", "image_stitch_tpu_torch/ops/fused.py",
                "image_stitch_tpu_torch/models/__init__.py"):
        assert rel in FILES


# The kernels' sources: each .cu with the .cuh whose bodies the host shim
# shares.
KERNEL_SOURCES = ("composite", "fdct_quant", "filter", "grid_dual", "idct", "layout", "pack_merge",
                  "symbols", "ycc")


def test_kernel_sources_are_listed():
    """csrc/ holds exactly these kernels (the build and the SASS report take
    every *.cu there), each with a header that host_shim.cpp includes; no
    source includes a header from outside csrc/ and the toolkit."""
    csrc = os.path.join(REPO, PORT, "csrc")
    assert sorted(os.listdir(csrc)) == sorted(
        [f"{k}.cu" for k in KERNEL_SOURCES] + [f"{k}.cuh" for k in KERNEL_SOURCES]
        + ["host_shim.cpp"])
    with open(os.path.join(csrc, "host_shim.cpp")) as f:
        shim = f.read()
    for k in KERNEL_SOURCES:
        assert f'#include "{k}.cuh"' in shim, k
        with open(os.path.join(csrc, f"{k}.cu")) as f:
            quoted = [line.split('"')[1] for line in f if line.startswith('#include "')]
        assert quoted and all(q.endswith(".cuh") and q[:-4] in KERNEL_SOURCES for q in quoted), k


def test_api_tests_import_both_packages_and_the_port_neither():
    """Only tests import both packages: tests/test_torch_api.py does, and
    the port's api.py, which it tests, imports neither jax nor the JAX
    package (it is in FILES above)."""
    with open(os.path.join(REPO, "tests", "test_torch_api.py")) as f:
        tree = ast.parse(f.read())
    tops = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    assert {"image_stitch_tpu", "image_stitch_tpu_torch"} <= tops
    assert f"{PORT}/api.py" in FILES


RUN = """
import importlib, pkgutil, sys
import numpy as np
import image_stitch_tpu_torch as port
from image_stitch_tpu_torch.codecs.png.writer import build_png
from image_stitch_tpu_torch.types import PngHeader
import zlib

for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)

def png(seed):
    rgba = np.random.default_rng(seed).integers(0, 256, (24, 40, 4), dtype=np.uint8)
    raw = np.concatenate([np.zeros((24, 1), np.uint8), rgba.reshape(24, -1)], axis=1)
    return build_png(PngHeader(width=40, height=24, bit_depth=8, color_type=6),
                     zlib.compress(raw.tobytes()))

tiles = [png(s) for s in range(4)]
jpeg = port.concat_to_buffer({"inputs": tiles, "layout": {"columns": 2},
                              "outputFormat": "jpeg"}, device="cpu")
assert jpeg[:2] == b"\\xff\\xd8" and jpeg[-2:] == b"\\xff\\xd9"
out = port.concat_to_buffer({"inputs": tiles, "layout": {"columns": 2}}, device="cpu")
assert out[:8] == b"\\x89PNG\\r\\n\\x1a\\n" and out[-8:-4] == b"IEND"
jpegs = [port.concat_to_buffer({"inputs": [t], "layout": {"columns": 1},
                                "outputFormat": "jpeg"}, device="cpu") for t in tiles]
counters = port.EncodeCounters()
out = port.concat_to_buffer({"inputs": jpegs, "layout": {"columns": 2}, "bandHeight": 8,
                             "outputFormat": "jpeg"}, device="cpu", counters=counters)
assert out[:2] == b"\\xff\\xd8" and out[-2:] == b"\\xff\\xd9"
assert counters.decode_bands_on_device and counters.decode_tile_bands
from image_stitch_tpu_torch.parallel.mesh import run_multichip_demo
assert run_multichip_demo(4, device="cpu")[1].shape == (32, 512)
for fmt in ("jpeg", "png"):
    counters = port.EncodeCounters()
    out = port.concat_to_buffer({"inputs": tiles, "layout": {"columns": 2}, "outputFormat": fmt,
                                 "jpegRestartIntervalRows": 1, "bandHeight": 16, "mesh": 4},
                                device="cpu", counters=counters)
    assert out[:2] in (b"\\xff\\xd8", b"\\x89P")
    assert counters.mesh_dispatches + counters.mesh_slabs > counters.bands + counters.png_bands
import os, tempfile
from image_stitch_tpu_torch.__main__ import main
with tempfile.TemporaryDirectory() as tmp:
    paths = []
    for i, t in enumerate(tiles):
        paths.append(os.path.join(tmp, f"t{i}.png"))
        with open(paths[-1], "wb") as f:
            f.write(t)
    for name in ("out.png", "out.jpg"):
        for mesh in ([], ["--mesh", "2"]):
            assert main([*paths, "--columns", "2", "-o", os.path.join(tmp, name), "--quiet",
                         "--device", "cpu", *mesh]) == 0
            assert os.path.getsize(os.path.join(tmp, name)) > 100
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("image_stitch_tpu", "jax")))
"""


def test_running_the_port_loads_nothing_of_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_probe_child_imports_only_the_port():
    """The link probe's child code (``ops/backend.py`` ``_PROBE_CHILD``)
    imports the port's own module, never the JAX package's; run for the CPU
    in a fresh process with the probe's PYTHONPATH, it prints the instant
    profile and loads nothing of the JAX package or jax."""
    from image_stitch_tpu_torch.ops.backend import _PROBE_CHILD

    code = _PROBE_CHILD.format(device="cpu")
    tree = ast.parse(code)
    imported = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    imported += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert imported == ["json", f"{PORT}.ops.backend"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    tail = ("import sys\nprint(sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('image_stitch_tpu', 'jax')))\n")
    proc = subprocess.run([sys.executable, "-c", code + tail], cwd="/", env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    profile, foreign = proc.stdout.strip().splitlines()[-2:]
    assert profile == '[1000000.0, 0.0, 1000000.0, "cpu"]'
    assert foreign == "[]"
