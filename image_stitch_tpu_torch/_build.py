"""Build the hand-written kernels from ``csrc/`` on first use.

Counterpart of ``image_stitch_tpu/native/__init__.py::_build_library``: the
library is compiled once into a directory keyed by a hash of its sources
and the command line, and loaded with ``ctypes``.

- :func:`load_cuda_kernels` runs ``nvcc`` for ``sm_90a`` over
  ``csrc/*.cu`` into ``build/torch_kernels/<sha>/`` under the checkout:
  one ``nvcc -c`` per source, all started together, then one link. It
  raises :class:`KernelBuildError`, with the compiler's output, when
  ``nvcc`` is missing or the build fails; nothing falls back.
- :func:`load_host_shim` runs ``g++`` over ``csrc/host_shim.cpp``, a
  serial CPU build of the same per-block bodies. Only the tests load it.
- :func:`build_native` runs ``g++`` over the host tier's C++ library
  (``native/stitchnative.cpp``: inflate, defilter, deflate, RGBA expansion,
  compositing, buffer pool) into ``build/torch_native/<sha>/``; the
  ``native`` module loads it on first use.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build")
BUILD_ROOT = os.path.join(_BUILD, "torch_kernels")
NATIVE_ROOT = os.path.join(_BUILD, "torch_native")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]
GXX_FLAGS = ["-std=c++17", "-O2", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_U32 = ctypes.c_uint32
_U64 = ctypes.c_uint64
_I64 = ctypes.c_int64
_GEOM = ctypes.POINTER(ctypes.c_int32)

_loaded: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """The kernels could not be compiled or loaded."""


def _find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, $PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built"
    )


def _build(name: str, compiler: str, flags: list[str], sources: list[str],
           root: str = BUILD_ROOT, hashed: list[str] | None = None,
           key: str = "") -> str:
    """Compile ``sources`` into ``<root>/<name>-<sha>/lib<name>.so`` unless
    it is there already; return its path. The sha covers the compiler, the
    flags, ``key`` and the ``hashed`` files (every file of csrc/ unless
    given). Each source compiles to an object in its own process, all
    started together; one more call links them."""
    h = hashlib.sha256()
    h.update(" ".join([os.path.basename(compiler)] + flags + [key]).encode())
    if hashed is None:
        hashed = glob.glob(os.path.join(_CSRC, "*"))
    for path in sorted(hashed):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    out_dir = os.path.join(root, f"{name}-{h.hexdigest()[:16]}")
    lib_path = os.path.join(out_dir, f"lib{name}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    # Build in a private temporary directory and rename the library into
    # place: concurrent builds (test workers) each produce a whole file, and
    # the rename is atomic.
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objects = [os.path.join(tmp, f"{i}.o") for i in range(len(sources))]
        cmds = [[compiler, *flags, "-I", _CSRC, "-c", "-o", obj, src]
                for obj, src in zip(objects, sources)]
        _run_all(cmds)
        tmp_lib = os.path.join(tmp, "lib.so")
        _run_all([[compiler, *flags, "-shared", "-o", tmp_lib, *objects]])
        os.replace(tmp_lib, lib_path)
    return lib_path


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands in parallel; raise with every failure's output.
    Every process started is waited for, or killed, before this returns."""
    procs: list[subprocess.Popen] = []
    for cmd in cmds:
        try:
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
        except OSError as e:
            for proc in procs:
                proc.kill()
                proc.communicate()
            raise KernelBuildError(f"{' '.join(cmd)} could not run: {e}") from e
    failures = []
    for cmd, proc in zip(cmds, procs):
        try:
            out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
            failures.append(f"{' '.join(cmd)} timed out:\n{err}{out}")
            continue
        if proc.returncode != 0:
            failures.append(f"{' '.join(cmd)} failed with code {proc.returncode}:\n{err}{out}")
    if failures:
        raise KernelBuildError("\n".join(failures))


def load_cuda_kernels() -> ctypes.CDLL:
    """Build (once) and load the CUDA kernels for sm_90a."""
    if "cuda" not in _loaded:
        sources = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
        lib = ctypes.CDLL(_build("torch_kernels", _find_nvcc(), NVCC_FLAGS, sources))
        lib.pack_merge_launch.restype = _I
        lib.pack_merge_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _P]
        lib.filter_select_launch.restype = _I
        lib.filter_select_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
        lib.composite_segments_launch.restype = _I
        lib.composite_segments_launch.argtypes = [_P, _I, _P, _U32, _P, _I, _I, _P, _P]
        lib.idct_dequant_batch_launch.restype = _I
        lib.idct_dequant_batch_launch.argtypes = [_P, _P, _P, _I, _P, _P]
        lib.ycc_rgba_batch_launch.restype = _I
        lib.ycc_rgba_batch_launch.argtypes = [_P, _P, _I, _I, _P, _I64, _I, _P]
        lib.fdct_quant_launch.restype = _I
        lib.fdct_quant_launch.argtypes = [_P, _I, _I, _I, _P, _P, _I, _I, _P, _P, _P, _P]
        lib.symbol_streams_launch.restype = _I
        lib.symbol_streams_launch.argtypes = [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                                              _P]
        lib.group_layout_launch.restype = _I
        lib.group_layout_launch.argtypes = [_P, _I, _I, _P, _P, _I, _P, _P, _P, _P, _P]
        lib.grid_dual_launch.restype = _I
        lib.grid_dual_launch.argtypes = [_P, _P, _I, _I, _I, _I, _I, _P, _P, _I, _I, _I, _P, _P,
                                         _P, _P, _P, _P, _P, _I, _U64, _U32, _P]
        _loaded["cuda"] = lib
    return _loaded["cuda"]


def _gxx() -> str:
    compiler = shutil.which("g++")
    if compiler is None:
        raise KernelBuildError("g++ not found: the host C++ cannot be built")
    return compiler


def build_native(src: str, flags: list[str], key: str) -> str:
    """Compile the host tier's C++ library ``src`` with g++ into
    ``build/torch_native/`` (keyed by the source, ``flags`` and ``key``) and
    return the library's path. Raises :class:`KernelBuildError`."""
    return _build("stitchnative", _gxx(), flags, [src], root=NATIVE_ROOT,
                  hashed=[src], key=key)


def load_host_shim() -> ctypes.CDLL:
    """Build (once) and load the serial CPU build of the kernel bodies.
    Test-only: the encoder never calls it."""
    if "host" not in _loaded:
        src = [os.path.join(_CSRC, "host_shim.cpp")]
        lib = ctypes.CDLL(_build("torch_kernels_host", _gxx(), GXX_FLAGS, src))
        lib.pack_merge_host.restype = None
        lib.pack_merge_host.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I]
        lib.filter_select_host.restype = None
        lib.filter_select_host.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I]
        lib.filter_words_host.restype = None
        lib.filter_words_host.argtypes = [_I, _P, _P, _P, _P, _P, _P, _I]
        lib.composite_divmod_host.restype = None
        lib.composite_divmod_host.argtypes = [_P, _P, _P, _P, _I]
        lib.alpha_over_host.restype = _I
        lib.alpha_over_host.argtypes = [_P, _P, _I]
        lib.composite_segments_host.restype = _I
        lib.composite_segments_host.argtypes = [_P, _I, _P, _P, _P, _I, _I]
        lib.idct_dequant_host.restype = None
        lib.idct_dequant_host.argtypes = [_P, _I, _I, _P, _I, _P]
        lib.ycc_rgba_host.restype = None
        lib.ycc_rgba_host.argtypes = [_P, _P, _P, _GEOM, _I, _P, _I64, _I, _I, _I]
        lib.idct_dequant_batch_host.restype = None
        lib.idct_dequant_batch_host.argtypes = [_P, _P, _P, _I, _P]
        lib.idct_range_limit_host.restype = None
        lib.idct_range_limit_host.argtypes = [_P, _P, _P, _I]
        lib.idct_pass_host.restype = None
        lib.idct_pass_host.argtypes = [_P, _I]
        lib.ycc_rgba_batch_host.restype = None
        lib.ycc_rgba_batch_host.argtypes = [_P, _P, _I, _I, _P, _I64, _I]
        lib.fdct_quant_host.restype = None
        lib.fdct_quant_host.argtypes = [_P, _I, _I, _I, _P, _P, _I, _P, _P, _P]
        lib.symbol_streams_host.restype = None
        lib.symbol_streams_host.argtypes = [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P]
        lib.sym_divides_host.restype = None
        lib.sym_divides_host.argtypes = [_P, _P, _P, _I]
        lib.group_layout_host.restype = None
        lib.group_layout_host.argtypes = [_P, _I, _I, _P, _P, _P, _P, _P]
        lib.fdct_quantize_host.restype = None
        lib.fdct_quantize_host.argtypes = [_P, _P, _P, _I]
        lib.fdct_quantize_recip_host.restype = None
        lib.fdct_quantize_recip_host.argtypes = [_P, _P, _P, _I]
        lib.grid_dual_ctas_host.restype = _I
        lib.grid_dual_ctas_host.argtypes = [_I, _I]
        lib.grid_dual_host.restype = None
        lib.grid_dual_host.argtypes = [_P, _P, _I, _I, _I, _I, _I, _P, _P, _I, _I, _P, _P, _P,
                                       _P, _P, _P]
        _loaded["host"] = lib
    return _loaded["host"]
