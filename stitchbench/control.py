"""The controls: the plain reference put in the program's place, one step
below what the configuration states, at a cell's own size.

    python3 stitchbench/control.py --workload <cell> --seeds N [N ...]

For each seed it makes the output of a job of the cell as each control
computes it, and reads the numbers that decide ``correct`` against the
exact reference, as a run reads its drawn job; a sound control comes out
not correct. For JPEG output the control computes the forward DCT in
float32 (the step a faster encoder would be tempted to take) instead of
libjpeg's exact integer transform. For PNG output, which states no
precision, each control breaks one stated guarantee: ``level1`` keeps the
adaptive filter choice and deflates at zlib level 1 instead of the stated
level 6 (the step that would tempt a change to the host's deflate, the most
of a PNG job's time); ``paeth`` keeps the level and filters every row with
Paeth. The benchmark's own runs never run it. Needs no card: the control
is the reference's own code, on the workers of the pool.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CONTROLS = {"jpeg": ("float32",), "png": ("level1", "paeth")}


def deflate_part(rows, r0, r1, choice, level):
    """Filtered canvas rows r0:r1 and their raw deflate data at ``level``,
    ended by a sync flush so that the parts join into one stream (a pool
    task)."""
    from stitchbench.reference.check import filtered_part

    data = filtered_part(rows, r0, r1, choice).tobytes()
    z = zlib.compressobj(level, zlib.DEFLATED, -zlib.MAX_WBITS)
    return data, z.compress(data) + z.flush(zlib.Z_SYNC_FLUSH)


def control_png(spec, pool, choice: str, level: int) -> bytes:
    from stitchbench.reference import check as ref
    from stitchbench.reference import png as ref_png

    h, w = spec.canvas
    args = [(spec.rows, r0, min(r0 + ref.RANGE_ROWS, h), choice, level)
            for r0 in range(0, h, ref.RANGE_ROWS)]
    adler = 1
    stream = [b"\x78\x9c"]
    for data, deflated in pool.map("stitchbench.control:deflate_part", args):
        adler = zlib.adler32(data, adler)
        stream.append(deflated)
    stream += [b"\x03\x00", adler.to_bytes(4, "big")]     # an empty final block
    return (ref_png.SIGNATURE + ref_png.ihdr(w, h) + ref_png.chunk(b"IDAT", b"".join(stream))
            + ref_png.chunk(b"IEND", b""))


def control_numbers(cell, seed: int, pool, control: str, job: int = 0) -> dict:
    """The numbers compared when ``control``'s output of job ``job`` stands
    in for the program's, as a run compares its drawn job."""
    from stitchbench.reference import check as ref

    spec = cell.traffic.job(seed, None, job).spec
    opts = cell.options
    if control == "float32":
        out = ref.expected_jpeg(spec, opts, pool, precision="float32")
    else:
        choice, level = {"level1": ("adaptive", 1),
                         "paeth": ("paeth", opts["pngCompressionLevel"])}[control]
        out = control_png(spec, pool, choice, level)
    return ref.check(spec, opts, out, pool)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from stitchbench.common.manifest import Cell
    from stitchbench.common.pool import Pool
    from stitchbench.reference.check import limits_hold

    cell = Cell.load(ROOT, args.workload)
    with Pool() as pool:
        for seed in args.seeds:
            for control in CONTROLS[cell.options["outputFormat"]]:
                t = time.perf_counter()
                compared = limits_hold(control_numbers(cell, seed, pool, control))
                print(json.dumps({"workload": cell.name, "seed": seed, "control": control,
                                  "correct": all(c["holds"] for c in compared.values()),
                                  "seconds": time.perf_counter() - t, "checks": compared}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
