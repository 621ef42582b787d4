"""The yardstick's arithmetic: bytes a job's device work must move, the
card's peak, and interval arithmetic over the device's activities.

A job's device work reads its inputs once and writes its outputs once:
- in, what the job's kind counts (``JobSpec.input_bytes``): the canvas's
  pixels uploaded band by band, or the coefficients of tiles the card
  decodes;
- out, for JPEG output, the entropy-coded stream (the output's bytes); for
  PNG output, the filtered rows (a filter byte and 4 bytes a pixel a row).
Intermediates (decoded bands, blocks, symbols, bit counts) are not counted:
an ideal implementation keeps them on chip. The count follows from shapes
and output sizes alone, so it reads the same work whatever kernels
implement it.
"""

from __future__ import annotations

# H100 SXM HBM3 rate (NVIDIA data sheet), at the card's full 700 W.
HBM_BYTES_PER_S = 3.35e12


def bound_ms(n_bytes: int) -> float:
    """Least time the card could take to move ``n_bytes`` (each input read
    once, each output written once) at the H100's 3.35 TB/s."""
    return n_bytes / HBM_BYTES_PER_S * 1e3


def device_bytes(options: dict, spec, out_bytes: int) -> int:
    """A job's inputs (``spec.input_bytes``, counted by its kind) and its
    output: the entropy-coded stream for JPEG, the filtered rows for PNG."""
    if options["outputFormat"] == "jpeg":
        return spec.input_bytes + out_bytes
    h, w = spec.canvas
    return spec.input_bytes + h * (1 + 4 * w)


def union_seconds(intervals: list[tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def gaps(intervals: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of [lo, hi] that no interval covers."""
    out, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            out.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return [(a, b) for a, b in out if b > a]
