"""What nvcc makes of the hand-written kernels: registers, spills and SASS.

    python -m image_stitch_tpu_torch.sass_report [--dump DIR] [--csrc DIR]

Compiles each ``*.cu`` of the port's ``csrc/`` (or of another source
directory, such as an earlier checkout's, with ``--csrc``) to a cubin for
sm_90a with the kernels' own flags plus ``-Xptxas -v`` (one ``nvcc`` per
source, all started together), disassembles it with ``cuobjdump
--dump-sass``, and prints per kernel function: registers, spill bytes and
shared memory from ptxas, the count of SASS instructions, and each loop's
body (from a backward branch to its target) with its instruction count,
innermost first. With ``--dump`` the SASS listings are written to DIR.
Needs the CUDA toolkit; no GPU.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import shutil
import subprocess
import tempfile

from ._build import _CSRC, BUILD_ROOT, NVCC_FLAGS, _find_nvcc

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
_BRA = re.compile(r"\bBRA(?:\.\w+)*\s+(0x[0-9a-f]+)")
_PTXAS_FN = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_USE = re.compile(r"Used (\d+) registers")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_SMEM = re.compile(r"(\d+) bytes smem")


def _demangle(names: list[str]) -> dict[str, str]:
    tool = shutil.which("c++filt") or shutil.which("cu++filt")
    if not tool or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                         timeout=60).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else {n: n for n in names}


def parse_ptxas(log: str) -> dict[str, dict]:
    """{mangled function: {"registers", "spill_stores", "spill_loads",
    "smem"}} from ``-Xptxas -v`` output."""
    info: dict[str, dict] = {}
    fn = None
    for line in log.splitlines():
        m = _PTXAS_FN.search(line)
        if m:
            fn = m.group(1)
            info[fn] = {}
            continue
        if fn is None:
            continue
        if (m := _SPILL.search(line)):
            info[fn]["spill_stores"], info[fn]["spill_loads"] = int(m.group(1)), int(m.group(2))
        if (m := _PTXAS_USE.search(line)):
            info[fn]["registers"] = int(m.group(1))
            if (s := _SMEM.search(line)):
                info[fn]["smem"] = int(s.group(1))
    return info


def parse_sass(text: str) -> dict[str, dict]:
    """{mangled function: {"instructions": n, "loops": [(start, end, n)]}}
    from ``cuobjdump --dump-sass``: a loop is the instructions from a
    backward branch's target to the branch."""
    funcs: dict[str, list[tuple[int, str]]] = {}
    cur = None
    for line in text.splitlines():
        if "Function :" in line:
            cur = line.split("Function :", 1)[1].strip()
            funcs[cur] = []
            continue
        m = _INSN.search(line)
        if cur is not None and m:
            funcs[cur].append((int(m.group(1), 16), m.group(2).strip()))
    out = {}
    for name, insns in funcs.items():
        body = [(a, t) for a, t in insns if t != "NOP"]
        loops = []
        for addr, text_ in body:
            b = _BRA.search(text_)
            if b and int(b.group(1), 16) < addr:  # not the BRA-to-self after EXIT
                start = int(b.group(1), 16)
                loops.append((start, addr, sum(1 for a, _ in body if start <= a <= addr)))
        out[name] = {"instructions": len(body), "loops": sorted(loops, key=lambda l: l[2])}
    return out


def report(dump_dir: str | None = None, csrc: str = _CSRC) -> list[str]:
    """Compile, disassemble and summarise every ``*.cu`` of ``csrc``; the
    lines to print."""
    nvcc = _find_nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.exists(cuobjdump):
        cuobjdump = shutil.which("cuobjdump") or cuobjdump
    sources = sorted(glob.glob(os.path.join(csrc, "*.cu")))
    os.makedirs(BUILD_ROOT, exist_ok=True)
    lines = []
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        procs = []
        for src in sources:
            cubin = os.path.join(tmp, os.path.basename(src) + ".cubin")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-I", csrc, "-cubin", "-o", cubin, src]
            procs.append((src, cubin, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                       stderr=subprocess.STDOUT, text=True)))
        for src, cubin, proc in procs:
            log, _ = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{log}")
            sass = subprocess.run([cuobjdump, "--dump-sass", cubin], capture_output=True,
                                  text=True, timeout=120, check=True).stdout
            if dump_dir:
                os.makedirs(dump_dir, exist_ok=True)
                with open(os.path.join(dump_dir, os.path.basename(src) + ".sass"), "w") as f:
                    f.write(sass)
            ptxas = parse_ptxas(log)
            funcs = parse_sass(sass)
            names = _demangle(sorted(funcs))
            for fn in sorted(funcs):
                p = ptxas.get(fn, {})
                f = funcs[fn]
                loops = ", ".join(f"[{s:#x}..{e:#x}] {n}" for s, e, n in f["loops"]) or "none"
                lines.append(
                    f"sass {os.path.basename(src)} {names[fn]}: {p.get('registers', '?')} "
                    f"registers, spills {p.get('spill_stores', '?')}/{p.get('spill_loads', '?')} B, "
                    f"smem {p.get('smem', 0)} B, {f['instructions']} instructions; loops "
                    f"(first to backward branch, instructions): {loops}")
    return lines


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dump", help="write each source's SASS listing to this directory")
    ap.add_argument("--csrc", default=_CSRC, help="the directory of .cu sources to compile")
    args = ap.parse_args()
    for line in report(args.dump, os.path.abspath(args.csrc)):
        print(line, flush=True)


if __name__ == "__main__":
    main()
