"""Batched decode of many small same-format PNG tiles.

Many-tiny-tile grids (the reference's pngsuite-style sweeps through
image-concat-core.ts:389-549) spend most of their time in per-tile
Python glue: generator machinery, a per-tile defilter call, and a
per-tile ``convert_band`` whose numpy fixed costs (~50 us) dwarf the
32x32 pixels it converts. This module groups tiles that share a decode
signature (dims, bit depth, color type, palette/tRNS bytes) and runs the
whole group through ONE defilter call and ONE convert_band call:

- per tile: inflate its own IDAT stream (decompression state is
  inherently per-stream) into a shared stacked scanline-unit buffer,
  with one zeroed separator row before each tile — a type-0 row of
  zeros reproduces the prev_row=None filter semantics exactly, so a
  single defilter pass over the stack is bit-identical to per-tile
  defilters;
- per group: one defilter over (N*(h+1), 1+row_bytes), one convert over
  the re-stacked (N*h, row_bytes) raw scanlines, then per-tile views.

Bit-exactness: identical output to the per-tile path by construction
(same inflate tier, same defilter kernels, same convert_band); covered
by tests/unit/test_group_decode.py against the standalone decoder.

Safety: the group path never mutates the member decoders (it reads the
buffer walk's ``_idat_spans`` only), so any group-decode failure falls
back to the untouched per-tile path, which re-raises with the proper
per-input error attribution.
"""

from __future__ import annotations

import threading
from typing import Callable, Mapping, Sequence

import numpy as np

from ...utils import get_bytes_per_pixel, scanline_byte_length

# A tile is group-eligible when it is small enough that per-tile fixed
# costs dominate (above ~128^2 the numpy work amortizes them anyway).
MAX_TILE_PIXELS = 128 * 128
# Bound the group working set (RGBA16 worst case: 8 B/px -> 64 MB).
MAX_GROUP_PIXELS = 8 << 20
MIN_GROUP = 4


def _tile_key(header, meta: Mapping) -> tuple | None:
    pal = meta.get("palette")
    trns = meta.get("trns")
    return (
        header.width,
        header.height,
        header.bit_depth,
        header.color_type,
        header.interlace_method,
        None if pal is None else pal.tobytes(),
        None if trns is None else trns.tobytes(),
    )


def _eligible(dec, header) -> bool:
    from .decoder import PngDecoder

    # Strict (buffer-default) decoders are groupable too: their chunk
    # CRCs were already verified during the buffer walk (any failure sets
    # _idat_defer, which excludes the tile here), and the group inflate
    # verifies each tile's Adler-32 trailer (see _decode_all) — the same
    # integrity set the per-tile strict path enforces.
    return (
        isinstance(dec, PngDecoder)
        and getattr(dec, "_buf", None) is not None
        and getattr(dec, "_idat_spans", None) is not None
        and getattr(dec, "_idat_defer", None) is None
        and header.interlace_method in (0, 1)
        and 0 < header.width * header.height <= MAX_TILE_PIXELS
    )


class _Group:
    """One decode group: lazily decoded on first member access."""

    def __init__(self, header, meta: Mapping, indices: list[int],
                 decoders: Sequence, target_depth: int):
        self._header = header
        self._meta = meta
        self._indices = indices
        self._decoders = {i: decoders[i] for i in indices}
        self._target_depth = target_depth
        self._lock = threading.Lock()
        self._results: dict[int, np.ndarray] | None = None
        self._failed = False

    @staticmethod
    def _tile_inflater():
        """One-shot whole-tile inflate: (idat_spans, out_flat) -> bytes
        written. The native path drives the raw C inflate with ONE pooled
        state reused across the group's tiles (owned_inflate_init resets
        it) — a per-tile StreamingInflator cost ~25 us of wrapper glue,
        which at 32x32 tiles was comparable to the decode itself.

        The returned callable takes (spans, out_flat, verify_adler):
        strict tiles also check the stream's Adler-32 trailer (AVX2
        stitch_adler32 over the produced bytes vs the trailer the decoder
        parsed) — the same check the per-tile strict inflator performs."""
        from ...native import get_native_lib

        lib = get_native_lib()
        if lib is None:
            import zlib

            def inflate_zlib(spans, out_flat: np.ndarray,
                             verify_adler: bool = False) -> int:
                # zlib.decompress verifies the Adler trailer itself.
                data = zlib.decompress(b"".join(bytes(s) for s in spans))
                fill = min(len(data), len(out_flat))
                out_flat[:fill] = np.frombuffer(data[:fill], dtype=np.uint8)
                return fill

            return inflate_zlib

        from ...native import buffer_pool

        st = buffer_pool.get(int(lib.owned_inflate_state_size()))
        stp = st.ctypes.data

        def inflate_native(spans, out_flat: np.ndarray,
                           verify_adler: bool = False) -> int:
            # `st` must be referenced here, not just its raw address: a
            # closure over the int alone would let the state array be
            # collected while C code still writes through it.
            assert st is not None
            lib.owned_inflate_init(stp)
            comp = (
                np.frombuffer(spans[0], dtype=np.uint8)
                if len(spans) == 1
                else np.frombuffer(
                    b"".join(bytes(s) for s in spans), dtype=np.uint8
                )
            )
            fill = 0
            need = len(out_flat)
            out_ptr = out_flat.ctypes.data
            while fill < need:
                got = lib.owned_inflate(
                    comp.ctypes.data, len(comp), stp, out_ptr + fill,
                    need - fill,
                )
                if got <= 0:
                    if got < 0:
                        raise ValueError(f"invalid tile stream rc={got}")
                    break
                fill += got
            if fill == need:
                # The per-tile path enforces a complete stream and no
                # residual decompressed bytes in EVERY mode (decoder.bands
                # verify_finished + fill>0 checks); match it so grouping
                # never changes which inputs are accepted. The 8-byte
                # probe drain advances state 4 -> 5 when the trailer was
                # pending, and catches over-long streams.
                probe = np.empty(8, dtype=np.uint8)
                got = lib.owned_inflate(
                    comp.ctypes.data, len(comp), stp, probe.ctypes.data, 8
                )
                if got != 0:
                    raise ValueError("residual decompressed bytes")
                if lib.owned_inflate_state(stp) != 5:
                    raise ValueError("truncated tile stream")
                if verify_adler:
                    stored = int(lib.owned_inflate_stream_adler(stp))
                    computed = int(lib.stitch_adler32(out_ptr, need, 1))
                    if stored != computed:
                        raise ValueError("tile stream Adler-32 mismatch")
            return fill

        return inflate_native

    def take(self, idx: int) -> np.ndarray | None:
        """Converted (h, w, C) array for member ``idx``, or None if the
        group decode failed (caller falls back to the per-tile path)."""
        with self._lock:
            if self._failed:
                return None
            if self._results is None:
                try:
                    self._results = self._decode_all()
                except Exception:
                    self._failed = True
                    return None
            return self._results.pop(idx, None)

    def _decode_all(self) -> dict[int, np.ndarray]:
        from ...ops.pixel import convert_band
        from .decoder import _defilter_units

        h = self._header
        n = len(self._indices)
        row_bytes = scanline_byte_length(h.width, h.bit_depth, h.color_type)
        bpp = get_bytes_per_pixel(h.bit_depth, h.color_type)
        inflate_tile = self._tile_inflater()
        if h.interlace_method == 1:
            # Interlaced: inflate each tile's pass-concatenated payload
            # into its row, then ONE batched Adam7 deinterlace (one
            # defilter + one strided scatter per pass for the whole
            # group — ops/adam7.deinterlace_adam7_batch).
            from ...ops.adam7 import adam7_payload_length, deinterlace_adam7_batch

            need = adam7_payload_length(h)
            stack = np.zeros((n, need), dtype=np.uint8)
            for k, idx in enumerate(self._indices):
                dec = self._decoders[idx]
                fill = inflate_tile(
                    dec._idat_spans, stack[k], bool(dec._verify_crc)
                )
                if fill != need:
                    raise ValueError("short tile stream")
            raw = np.ascontiguousarray(
                deinterlace_adam7_batch(stack, h).reshape(
                    n * h.height, row_bytes
                )
            )
        else:
            unit = 1 + row_bytes
            rows = h.height + 1  # +1 zeroed separator row per tile
            stack = np.zeros((n * rows, unit), dtype=np.uint8)
            flat = stack.reshape(-1)
            need = h.height * unit
            for k, idx in enumerate(self._indices):
                dec = self._decoders[idx]
                base = (k * rows + 1) * unit
                fill = inflate_tile(
                    dec._idat_spans, flat[base : base + need],
                    bool(dec._verify_crc),
                )
                if fill != need:
                    raise ValueError("short tile stream")  # -> per-tile fallback
            raw = _defilter_units(stack, row_bytes, bpp, None)
            # Drop the separator rows and convert the whole group in one call.
            raw = np.ascontiguousarray(
                raw.reshape(n, rows, row_bytes)[:, 1:].reshape(
                    n * h.height, row_bytes
                )
            )
        conv = convert_band(
            raw,
            h.width,
            h.bit_depth,
            h.color_type,
            self._target_depth,
            palette=self._meta.get("palette"),
            trns=self._meta.get("trns"),
            copy=False,
        )
        return {
            idx: conv[k * h.height : (k + 1) * h.height]
            for k, idx in enumerate(self._indices)
        }


def plan_group_providers(
    decoders: Sequence,
    headers: Sequence,
    metas: Sequence[Mapping],
    target_depth: int,
) -> dict[int, Callable[[], np.ndarray | None]]:
    """Bucket eligible tiles by decode signature; return per-index lazy
    providers for every index that landed in a group of >= MIN_GROUP."""
    buckets: dict[tuple, list[int]] = {}
    for i, dec in enumerate(decoders):
        if not _eligible(dec, headers[i]):
            continue
        key = _tile_key(headers[i], metas[i])
        if key is None:
            continue
        buckets.setdefault(key, []).append(i)

    providers: dict[int, Callable[[], np.ndarray | None]] = {}
    for key, indices in buckets.items():
        if len(indices) < MIN_GROUP:
            continue
        px_per_tile = key[0] * key[1]
        cap = max(MIN_GROUP, MAX_GROUP_PIXELS // max(1, px_per_tile))
        for start in range(0, len(indices), cap):
            chunk = indices[start : start + cap]
            if len(chunk) < MIN_GROUP:
                # Tail smaller than a worthwhile group: per-tile path.
                continue
            group = _Group(
                headers[chunk[0]], metas[chunk[0]], chunk, decoders,
                target_depth,
            )
            for i in chunk:
                providers[i] = (lambda g, j: lambda: g.take(j))(group, i)
    return providers
