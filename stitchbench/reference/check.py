"""What decides ``correct``: a job's output against the plain reference.

JPEG output is compared byte for byte with the reference's encoding of the
same canvas (colour conversion, islow FDCT, exact quantization, Huffman
coding, stuffing, headers). PNG output is parsed and inflated with zlib,
and every filtered row (filter type and residuals) is compared with the
reference's adaptive filter choice on the same canvas; where asked, the
IDAT bytes are compared with zlib at the configuration's level (strategy
default) over the reference's filtered rows, so that a lower level or
stored blocks read as what they are. Canvas rows come from the job's
``JobSpec.rows``, rebuilt from the seed in parallel row ranges on the
pool's workers; a JPEG range starts from the DC predictors of the MCU row
above it.

Each ``check_*`` returns numbers that are 0 (or under their limit) for a
correct output.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from stitchbench.common.traffic import canvas_rows
from stitchbench.reference import jpeg as ref_jpeg
from stitchbench.reference import png as ref_png

RANGE_ROWS = 512          # rows of canvas a pool task rebuilds and codes


def _padded_rows(rows, height, r0, r1, m):
    """Canvas rows r0:r1 of the canvas padded by edge repetition to
    whole MCUs of height ``m`` (rows past ``height`` repeat the last)."""
    lo = min(r0, height - 1)
    out = canvas_rows(rows, lo, min(r1, height))
    if r1 > height:
        out = np.concatenate([out, np.repeat(out[-1:], r1 - max(r0, height), axis=0)])
    out = out[r0 - lo:]
    return ref_jpeg.pad_to(np.ascontiguousarray(out[..., :3]), 1, m)


def jpeg_part(rows, height: int, r0: int, r1: int, quality: int, sampling: str,
              precision: str):
    """Entropy-coded bits of padded canvas rows r0:r1 (a pool task)."""
    m = ref_jpeg.mcu_height(sampling)
    above = _padded_rows(rows, height, r0 - m, r0, m) if r0 else None
    prev = ref_jpeg.last_dcs(above, quality, sampling, precision)
    return ref_jpeg.encode_rows(_padded_rows(rows, height, r0, r1, m), quality, sampling, prev,
                                precision)


def expected_jpeg(spec, options: dict, pool, precision: str = "islow") -> bytes:
    """The reference's JPEG of a job's canvas; ``precision="float32"`` is
    the control."""
    h, w = spec.canvas
    q, s = options["jpegQuality"], options.get("jpegSampling", "444")
    m = ref_jpeg.mcu_height(s)
    padded = -(-h // m) * m
    step = -(-RANGE_ROWS // m) * m
    args = [(spec.rows, h, r0, min(r0 + step, padded), q, s, precision)
            for r0 in range(0, padded, step)]
    parts = pool.map("stitchbench.reference.check:jpeg_part", args)
    scan = ref_jpeg.finish_scan(*ref_jpeg.join_bits(parts))
    return ref_jpeg.header(w, h, q, s) + scan + b"\xff\xd9"


def check_jpeg(output: bytes, expected: bytes) -> dict:
    """Bytes that differ, counting a difference in length as bytes too."""
    a = np.frombuffer(output, np.uint8)
    b = np.frombuffer(expected, np.uint8)
    n = min(len(a), len(b))
    return {"jpeg_bytes_differing": int(np.count_nonzero(a[:n] != b[:n])) + abs(len(a) - len(b))}


def filtered_part(rows, r0: int, r1: int, choice: str) -> np.ndarray:
    """Filtered canvas rows r0:r1, each led by its filter type."""
    raw = canvas_rows(rows, max(r0 - 1, 0), r1)
    raw = raw.reshape(raw.shape[0], -1)
    return ref_png.filter_rows(raw[1:] if r0 else raw, raw[0] if r0 else None, choice=choice)


def png_part(rows, r0: int, r1: int, choice: str, level: int | None):
    """(filter types, CRC-32 of each filtered row, and with ``level`` the
    bytes zlib makes of them at that level) of canvas rows r0:r1 (a pool
    task)."""
    filtered = filtered_part(rows, r0, r1, choice)
    size = None if level is None else len(zlib.compress(filtered.tobytes(), level))
    return filtered[:, 0].copy(), np.array([zlib.crc32(r) for r in filtered], np.uint32), size


def expected_png(spec, pool, level: int | None = None, choice: str = "adaptive"):
    """(filter types, row CRCs, zlib bytes at ``level`` or None) of a job's
    canvas. The zlib bytes are summed over ranges of ``RANGE_ROWS`` rows
    compressed apart: a 32 KiB window in ranges of some MB, within 0.01% of
    one stream."""
    h = spec.canvas[0]
    args = [(spec.rows, r0, min(r0 + RANGE_ROWS, h), choice, level)
            for r0 in range(0, h, RANGE_ROWS)]
    parts = pool.map("stitchbench.reference.check:png_part", args)
    size = None if level is None else sum(p[2] for p in parts)
    return np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts]), size


def check_png(output: bytes, canvas: tuple[int, int], expected) -> dict:
    """Format errors (signature, IHDR, CRCs, chunk order, the zlib stream,
    its length), filtered rows that differ from the reference's and, where
    ``expected`` holds zlib's bytes, by how many percent the IDAT data
    exceeds them."""
    h, w = canvas
    errors = 0
    try:
        parts = ref_png.chunks(output)
    except ValueError:
        return {"png_format_errors": 1, "png_rows_differing": h}
    errors += sum(not ok for _, _, ok in parts)
    kinds = [k for k, _, _ in parts]
    if not kinds or kinds[0] != b"IHDR" or parts[0][1] != struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0):
        errors += 1
    if not kinds or kinds[-1] != b"IEND" or parts[-1][1]:
        errors += 1
    idat = [i for i, k in enumerate(kinds) if k == b"IDAT"]
    if not idat or idat != list(range(idat[0], idat[-1] + 1)):
        errors += 1
    raw = b""
    try:
        d = zlib.decompressobj()
        raw = d.decompress(b"".join(parts[i][1] for i in idat))
        if not d.eof or d.unused_data:
            errors += 1
    except zlib.error:
        errors += 1
    stride = 1 + 4 * w
    if len(raw) != h * stride:
        errors += 1
    rows = np.frombuffer(raw[: (len(raw) // stride) * stride], np.uint8).reshape(-1, stride)
    kinds_exp, crcs_exp, zlib_bytes = expected
    n = min(len(rows), h)
    crcs = np.array([zlib.crc32(r) for r in rows[:n]], np.uint32)
    differing = int(np.count_nonzero((crcs != crcs_exp[:n]) | (rows[:n, 0] != kinds_exp[:n])))
    out = {"png_format_errors": errors, "png_rows_differing": differing + (h - n)}
    if zlib_bytes:
        idat_bytes = sum(len(parts[i][1]) for i in idat)
        out["png_idat_excess_pct"] = 100.0 * (idat_bytes - zlib_bytes) / zlib_bytes
    return out


def check(spec, options: dict, output: bytes, pool, sized: bool = True) -> dict:
    """The numbers of one job's output. ``sized``: also compare a PNG's
    compressed size (the costlier part of its check)."""
    if options["outputFormat"] == "jpeg":
        return check_jpeg(output, expected_jpeg(spec, options, pool))
    level = options.get("pngCompressionLevel", 6) if sized else None
    return check_png(output, spec.canvas, expected_png(spec, pool, level))


def combine(totals: dict, numbers: dict) -> dict:
    """Numbers of several jobs: counts add up, percentages take the worst."""
    for k, v in numbers.items():
        totals[k] = max(totals[k], v) if k in totals and k.endswith("_pct") else \
            totals.get(k, 0) + v
    return totals


# Every number compared, with its limit: ("at_most", L) holds when the value
# is at most L; ("at_least", L) when it is at least L. The comparisons of
# bytes, rows and formats are exact, with the limit 0. The PNG size's limit
# lies between the program's readings at level 6 and the control's at
# level 1 (PERF.md, section 2).
LIMITS = {
    "jobs_checked": ("at_least", 1),
    "jobs_failed": ("at_most", 0),
    "jpeg_bytes_differing": ("at_most", 0),
    "png_format_errors": ("at_most", 0),
    "png_rows_differing": ("at_most", 0),
    "png_idat_excess_pct": ("at_most", 2.0),
}


def limits_hold(numbers: dict) -> dict:
    """Each number beside its limit, and whether it holds."""
    out = {}
    for name, value in numbers.items():
        kind, limit = LIMITS[name]
        holds = value <= limit if kind == "at_most" else value >= limit
        out[name] = {"value": value, "limit": limit, "is": kind, "holds": bool(holds)}
    return out
