"""Plain NumPy PNG: the adaptive filter choice the stitched output must
have, a whole-file writer for the benchmark's tiles, and a reader.

Filter choice (the upstream's ``png-filter.ts``, which libpng's heuristic
resembles): each row takes the filter of the five (None, Sub, Up, Average,
Paeth) whose residuals have the least sum of absolute values read as
signed bytes; ties go to the earlier filter. Paeth breaks its own ties
a, then b, then c. The row above the first is zero. Every candidate depends
on unfiltered rows only, so whole blocks of rows are filtered at once.

The reader inflates with ``zlib`` and undoes each row's filter; it serves
the tests and round trips, and is row-serial.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def chunk(kind: bytes, data: bytes) -> bytes:
    """One PNG chunk with its length and CRC."""
    return struct.pack(">I", len(data)) + kind + data + struct.pack(
        ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def ihdr(width: int, height: int, bit_depth: int = 8, color_type: int = 6) -> bytes:
    return chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, bit_depth, color_type, 0, 0, 0))


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filter_rows(rows: np.ndarray, above: np.ndarray | None, bpp: int = 4,
                choice: str = "adaptive") -> np.ndarray:
    """(h, n) uint8 raw rows, and the raw row above them (None: zeros), ->
    (h, 1 + n) filtered rows, each led by its filter type. ``choice``
    "adaptive" is the heuristic above; "paeth" filters every row with
    Paeth (the control's shortcut)."""
    cur = rows.astype(np.int16)
    up_row = np.zeros((1, rows.shape[1]), np.int16) if above is None else \
        above.astype(np.int16).reshape(1, -1)
    up = np.concatenate([up_row, cur[:-1]], axis=0)
    left = np.zeros_like(cur)
    left[:, bpp:] = cur[:, :-bpp]
    upleft = np.zeros_like(cur)
    upleft[:, bpp:] = up[:, :-bpp]
    cands = np.stack([cur, cur - left, cur - up, cur - ((left + up) >> 1),
                      cur - _paeth(left, up, upleft)]).astype(np.uint8)   # wraps mod 256
    if choice == "adaptive":
        score = np.abs(cands.view(np.int8).astype(np.int32)).sum(axis=2)
        kind = np.argmin(score, axis=0)                                  # first minimum
    elif choice == "paeth":
        kind = np.full(rows.shape[0], 4)
    else:
        raise ValueError(f"unknown filter choice {choice!r}")
    out = np.empty((rows.shape[0], rows.shape[1] + 1), np.uint8)
    out[:, 0] = kind
    out[:, 1:] = cands[kind, np.arange(rows.shape[0])]
    return out


def filter_image(rgba: np.ndarray, block_rows: int = 256) -> np.ndarray:
    """(H, W, 4) uint8 -> (H, 1 + 4W) filtered rows, in blocks of rows."""
    rows = rgba.reshape(rgba.shape[0], -1)
    parts = []
    for r0 in range(0, rows.shape[0], block_rows):
        above = rows[r0 - 1] if r0 else None
        parts.append(filter_rows(rows[r0: r0 + block_rows], above))
    return np.concatenate(parts, axis=0)


def encode(rgba: np.ndarray, level: int = 6, ancillary: list[bytes] = ()) -> bytes:
    """A whole RGBA8 PNG: adaptive filters, one zlib stream at ``level``,
    one IDAT; ``ancillary`` chunks follow IHDR."""
    h, w = rgba.shape[:2]
    data = zlib.compress(filter_image(rgba).tobytes(), level)
    return (SIGNATURE + ihdr(w, h) + b"".join(ancillary)
            + chunk(b"IDAT", data) + chunk(b"IEND", b""))


def text_chunk(keyword: str, text: str) -> bytes:
    return chunk(b"tEXt", keyword.encode("latin-1") + b"\0" + text.encode("latin-1"))


def chunks(png: bytes) -> list[tuple[bytes, bytes, bool]]:
    """(type, data, CRC matches) of every chunk; raises on a bad signature
    or a truncated chunk."""
    if png[:8] != SIGNATURE:
        raise ValueError("not a PNG signature")
    out, pos = [], 8
    while pos < len(png):
        if pos + 12 > len(png):
            raise ValueError("truncated chunk header")
        (n,) = struct.unpack(">I", png[pos: pos + 4])
        kind = png[pos + 4: pos + 8]
        end = pos + 8 + n
        if end + 4 > len(png):
            raise ValueError("truncated chunk")
        data = png[pos + 8: end]
        crc_ok = struct.unpack(">I", png[end: end + 4])[0] == zlib.crc32(kind + data) & 0xFFFFFFFF
        out.append((kind, data, crc_ok))
        pos = end + 4
    return out


def unfilter_rows(filtered: np.ndarray, width: int, bpp: int = 4) -> np.ndarray:
    """(h, 1 + n) filtered rows -> (h, n) raw rows (row-serial)."""
    h, n = filtered.shape[0], filtered.shape[1] - 1
    out = np.zeros((h, n), np.uint8)
    prev = np.zeros(n, np.int32)
    for r in range(h):
        kind, line = filtered[r, 0], filtered[r, 1:].astype(np.int32)
        if kind == 0:
            row = line
        elif kind == 2:
            row = (line + prev) & 0xFF
        else:
            row = np.zeros(n, np.int32)
            for x in range(n):
                a = row[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                pred = {1: a, 3: (a + b) >> 1, 4: int(_paeth(np.int32(a), np.int32(b), np.int32(c)))}[
                    int(kind)]
                row[x] = (line[x] + pred) & 0xFF
        out[r] = row
        prev = row.astype(np.int32)
    return out


def decode(png: bytes) -> np.ndarray:
    """An 8-bit RGBA, non-interlaced PNG -> (H, W, 4) uint8."""
    parts = chunks(png)
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", parts[0][1])
    if (depth, ctype, interlace) != (8, 6, 0):
        raise ValueError("the reader takes 8-bit RGBA, not interlaced")
    raw = zlib.decompress(b"".join(d for k, d, _ in parts if k == b"IDAT"))
    filtered = np.frombuffer(raw, np.uint8).reshape(h, 1 + 4 * w)
    return unfilter_rows(filtered, w).reshape(h, w, 4)
