"""PNG scanline (de)filtering over row bands — host oracle implementations.

Counterpart of the reference's ``src/png-filter.ts``. The reference works one
scanline at a time with per-byte JS loops (png-filter.ts:34-183); here the
unit of work is a *band* of rows so the encode side vectorizes completely
(all five filter candidates for every row of a band at once — the device
version lives in :mod:`image_stitch_tpu.ops.device`). The decode side has a
true sequential data dependence (left/up/up-left), so defiltering is a
host-side scan: ``Sub`` falls to a per-lane cumulative sum, ``Up``/``None``
vectorize, and ``Average``/``Paeth`` run a per-pixel recurrence.

Semantics frozen from the reference:
- Paeth predictor tie-breaking a, then b, then c (png-filter.ts:16-26).
- Encode filter choice: minimum sum of absolute *signed* byte values, strict
  ``<`` so ties go to the earlier candidate in order None, Sub, Up, Average,
  Paeth (png-filter.ts:148-183).
"""

from __future__ import annotations

import enum

import numpy as np

from ..errors import StitchError


class FilterType(enum.IntEnum):
    NONE = 0
    SUB = 1
    UP = 2
    AVERAGE = 3
    PAETH = 4


def paeth_predictor(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Vectorized Paeth predictor; inputs any integer arrays (promoted)."""
    a16 = a.astype(np.int16)
    b16 = b.astype(np.int16)
    c16 = c.astype(np.int16)
    p = a16 + b16 - c16
    pa = np.abs(p - a16)
    pb = np.abs(p - b16)
    pc = np.abs(p - c16)
    return np.where(
        (pa <= pb) & (pa <= pc), a16, np.where(pb <= pc, b16, c16)
    ).astype(np.uint8)


def _unfilter_sub(scanline: np.ndarray, bpp: int) -> np.ndarray:
    # out[i] = scan[i] + out[i - bpp]  ==  per-lane (stride bpp) cumsum mod 256.
    n = scanline.shape[0]
    out = np.empty(n, dtype=np.uint8)
    for lane in range(bpp):
        vals = scanline[lane::bpp].astype(np.int64)
        out[lane::bpp] = (np.cumsum(vals) & 0xFF).astype(np.uint8)
    return out


def _unfilter_average(scanline: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    n = scanline.shape[0]
    out = np.empty(n, dtype=np.uint8)
    scan16 = scanline.astype(np.int16)
    prev16 = prev.astype(np.int16)
    out[:bpp] = ((scan16[:bpp] + (prev16[:bpp] >> 1)) & 0xFF).astype(np.uint8)
    for i in range(bpp, n, bpp):
        m = min(bpp, n - i)
        left = out[i - bpp : i - bpp + m].astype(np.int16)
        up = prev16[i : i + m]
        out[i : i + m] = (
            (scan16[i : i + m] + ((left + up) >> 1)) & 0xFF
        ).astype(np.uint8)
    return out


def _unfilter_paeth(scanline: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    n = scanline.shape[0]
    out = np.empty(n, dtype=np.uint8)
    scan16 = scanline.astype(np.int16)
    # First pixel: left = upleft = 0, predictor reduces to up.
    out[:bpp] = ((scan16[:bpp] + prev[:bpp]) & 0xFF).astype(np.uint8)
    for i in range(bpp, n, bpp):
        m = min(bpp, n - i)
        pred = paeth_predictor(
            out[i - bpp : i - bpp + m], prev[i : i + m], prev[i - bpp : i - bpp + m]
        )
        out[i : i + m] = ((scan16[i : i + m] + pred) & 0xFF).astype(np.uint8)
    return out


def unfilter_scanline(
    filter_type: int,
    scanline: np.ndarray,
    previous_line: np.ndarray | None,
    bytes_per_pixel: int,
) -> np.ndarray:
    """Undo one row's filter (reference: unfilterScanline, png-filter.ts:34-100)."""
    scanline = np.asarray(scanline, dtype=np.uint8)
    prev = (
        np.zeros_like(scanline)
        if previous_line is None
        else np.asarray(previous_line, dtype=np.uint8)
    )
    if filter_type == FilterType.NONE:
        return scanline.copy()
    if filter_type == FilterType.SUB:
        return _unfilter_sub(scanline, bytes_per_pixel)
    if filter_type == FilterType.UP:
        return (scanline.astype(np.int16) + prev).astype(np.uint8)
    if filter_type == FilterType.AVERAGE:
        return _unfilter_average(scanline, prev, bytes_per_pixel)
    if filter_type == FilterType.PAETH:
        return _unfilter_paeth(scanline, prev, bytes_per_pixel)
    raise StitchError(f"Unknown filter type: {filter_type}")


def unfilter_band(
    filter_types: np.ndarray,
    rows: np.ndarray,
    previous_row: np.ndarray | None,
    bytes_per_pixel: int,
) -> np.ndarray:
    """Defilter a band of rows. ``rows`` is (H, row_bytes) uint8 of filtered
    bytes; ``filter_types`` is (H,); ``previous_row`` is the last raw row of
    the preceding band (the inter-band carry) or None at image start.

    The y recurrence is sequential; fast-paths runs of None/Up rows, which
    vectorize across the whole run (a cross-row cumulative sum for Up).
    """
    rows = np.asarray(rows, dtype=np.uint8)
    h = rows.shape[0]
    out = np.empty_like(rows)
    prev = previous_row
    y = 0
    while y < h:
        ftype = int(filter_types[y])
        if ftype in (FilterType.NONE, FilterType.UP):
            # Extend the run of rows with no intra-row dependence.
            run_end = y + 1
            while run_end < h and int(filter_types[run_end]) in (
                FilterType.NONE,
                FilterType.UP,
            ):
                run_end += 1
            base = (
                np.zeros(rows.shape[1], dtype=np.int64)
                if prev is None
                else prev.astype(np.int64)
            )
            block = rows[y:run_end].astype(np.int64)
            # Zero the carry-in at every None row so the cumulative sum
            # restarts there, then add the band-entry carry to the prefix.
            is_up = filter_types[y:run_end] == FilterType.UP
            acc = base
            for j in range(run_end - y):
                acc = (block[j] + np.where(is_up[j], acc, 0)) & 0xFF
                out[y + j] = acc.astype(np.uint8)
            prev = out[run_end - 1]
            y = run_end
        else:
            out[y] = unfilter_scanline(ftype, rows[y], prev, bytes_per_pixel)
            prev = out[y]
            y += 1
    return out


def defilter_band(
    filter_types: np.ndarray,
    rows: np.ndarray,
    previous_row: np.ndarray | None,
    bytes_per_pixel: int,
    in_place: bool = False,
) -> np.ndarray:
    """Defilter a band through the fastest available tier: native C++
    (image_stitch_tpu/native) when built, else the numpy path.

    ``in_place=True`` may mutate ``rows`` (caller-owned buffers only)."""
    from ..native import defilter_band_native

    out = defilter_band_native(
        np.asarray(filter_types, dtype=np.uint8),
        np.asarray(rows, dtype=np.uint8),
        previous_row,
        bytes_per_pixel,
        in_place=in_place,
    )
    if out is not None:
        return out
    return unfilter_band(filter_types, rows, previous_row, bytes_per_pixel)


# ---------------------------------------------------------------------------
# Encode side: choose + apply the best filter for every row of a band.
# ---------------------------------------------------------------------------


def _band_candidates(
    rows: np.ndarray, previous_row: np.ndarray | None, bpp: int
) -> np.ndarray:
    """Return (5, H, row_bytes) uint8 of all filter candidates for the band."""
    rows = np.asarray(rows, dtype=np.uint8)
    h, n = rows.shape
    r16 = rows.astype(np.int16)

    up_rows = np.empty_like(rows)
    up_rows[1:] = rows[:-1]
    up_rows[0] = 0 if previous_row is None else np.asarray(previous_row, dtype=np.uint8)
    up16 = up_rows.astype(np.int16)

    left = np.zeros_like(rows)
    left[:, bpp:] = rows[:, :-bpp]
    left16 = left.astype(np.int16)

    upleft = np.zeros_like(up_rows)
    upleft[:, bpp:] = up_rows[:, :-bpp]

    cand = np.empty((5, h, n), dtype=np.uint8)
    cand[FilterType.NONE] = rows
    cand[FilterType.SUB] = ((r16 - left16) & 0xFF).astype(np.uint8)
    cand[FilterType.UP] = ((r16 - up16) & 0xFF).astype(np.uint8)
    cand[FilterType.AVERAGE] = ((r16 - ((left16 + up16) >> 1)) & 0xFF).astype(np.uint8)
    pred = paeth_predictor(left, up_rows, upleft)
    cand[FilterType.PAETH] = ((r16 - pred) & 0xFF).astype(np.uint8)
    return cand


def filter_select_band(
    rows: np.ndarray, previous_row: np.ndarray | None, bytes_per_pixel: int
) -> tuple[np.ndarray, np.ndarray]:
    """Pick and apply the best filter per row over a whole band at once.

    Returns ``(filter_types (H,) uint8, filtered (H, row_bytes) uint8)``.
    Selection metric matches the reference exactly: min sum of |signed byte|,
    first minimum wins (png-filter.ts:154-180).
    """
    rows = np.asarray(rows, dtype=np.uint8)
    h, row_bytes = rows.shape
    # Chunk over rows: the scoring temp below is 5 candidates x int64 =
    # 40x the raw chunk bytes (a 10 MB band would spike 400 MB — seen as a
    # no-native-tier memory-budget failure at 10000^2). ~1 MB of raw rows
    # per chunk caps the temp at ~45 MB. Exact: each chunk's first row only
    # needs the previous RAW row, which chunking preserves.
    chunk = max(1, (1 << 20) // max(1, row_bytes))
    if h > chunk:
        types_out = np.empty(h, dtype=np.uint8)
        filt_out = np.empty_like(rows)
        prev = previous_row
        for i in range(0, h, chunk):
            part = rows[i : i + chunk]
            types_out[i : i + chunk], filt_out[i : i + chunk] = (
                filter_select_band(part, prev, bytes_per_pixel)
            )
            prev = part[-1]
        return types_out, filt_out
    cand = _band_candidates(rows, previous_row, bytes_per_pixel)
    sums = np.abs(cand.view(np.int8).astype(np.int64)).sum(axis=2)  # (5, H)
    choice = np.argmin(sums, axis=0)  # first occurrence of min == earlier filter
    filtered = cand[choice, np.arange(h)]
    return choice.astype(np.uint8), filtered


def filter_scanline(
    scanline: np.ndarray,
    previous_line: np.ndarray | None,
    bytes_per_pixel: int,
) -> tuple[int, np.ndarray]:
    """Single-row convenience matching the reference's ``filterScanline``."""
    rows = np.asarray(scanline, dtype=np.uint8)[None, :]
    types, filtered = filter_select_band(rows, previous_line, bytes_per_pixel)
    return int(types[0]), filtered[0]


def get_bytes_per_pixel(bit_depth: int, color_type: int) -> int:
    from ..utils import get_bytes_per_pixel as _g

    return _g(bit_depth, color_type)
