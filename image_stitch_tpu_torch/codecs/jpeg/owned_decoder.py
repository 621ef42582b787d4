"""Owned (from-scratch) JPEG decoder — host Huffman + array IDCT.

Tier-2 decoder used when PIL is unavailable or ``force_owned`` is set,
mirroring the reference's pure-JS jpeg-js fallback (jpeg-decoder.ts:250-262).
Supports baseline sequential DCT (SOF0/SOF1) and progressive DCT (SOF2,
spectral selection + successive approximation per T.81 §G), grayscale and
3-component YCbCr with 4:4:4 / 4:2:2 / 4:2:0 sampling, restart intervals,
and custom quant/Huffman tables. The bitstream walk is host-serial (as it
must be); dequantize + IDCT + upsample + color convert are vectorized over
all blocks.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ...errors import StitchError
from .tables import ZIGZAG


def _idct_matrix() -> np.ndarray:
    k = np.arange(8)
    c = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    m = c * np.sqrt(2.0 / 8.0)
    m[0, :] = np.sqrt(1.0 / 8.0)
    return m.astype(np.float32)


_DCT = _idct_matrix()


@dataclass
class _Component:
    comp_id: int
    h: int
    v: int
    tq: int
    td: int = 0
    ta: int = 0
    blocks: np.ndarray | None = None  # (by*bx, 64): int32 natural, or int16 zigzag
    bx: int = 0
    by: int = 0
    # The zigzag store's figures (decode_zigzag_coefficients): the highest
    # nonzero zigzag position (-1: none), the peak |coefficient|; None until
    # a scan has stored the component.
    last: int | None = None
    peak: int = 0


class _NaturalRoute(Exception):
    """The stream is not one the zigzag store takes (progressive, the
    native tier absent, a component scanned twice or never, a value past
    int16): it goes the natural-order route, ``decode_coefficients``."""


class _BitReader:
    """MSB-first bit reader over the entropy-coded segment with 0xFF00
    unstuffing; stops at markers."""

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self.val = 0
        self.n = 0

    def _fill(self) -> None:
        while self.n <= 24:
            if self.pos >= len(self.data):
                self.val = (self.val << 8) | 0
                self.n += 8
                continue
            b = self.data[self.pos]
            if b == 0xFF:
                nxt = self.data[self.pos + 1] if self.pos + 1 < len(self.data) else 0xD9
                if nxt == 0x00:
                    self.pos += 2
                elif 0xD0 <= nxt <= 0xD7:
                    # Restart marker: caller resets via sync_restart().
                    self.val = (self.val << 8) | 0
                    self.n += 8
                    continue
                else:
                    # Real marker (EOI etc.): pad with zeros.
                    self.val = (self.val << 8) | 0
                    self.n += 8
                    continue
            else:
                self.pos += 1
            self.val = (self.val << 8) | b
            self.n += 8

    def bits(self, count: int) -> int:
        if count == 0:
            return 0
        if self.n < count:
            self._fill()
        out = (self.val >> (self.n - count)) & ((1 << count) - 1)
        self.n -= count
        self.val &= (1 << self.n) - 1
        return out

    def bit(self) -> int:
        return self.bits(1)

    def sync_restart(self) -> None:
        """Discard buffered bits, skip to just past the next RSTn marker."""
        self.val = 0
        self.n = 0
        while self.pos + 1 < len(self.data):
            if self.data[self.pos] == 0xFF and 0xD0 <= self.data[self.pos + 1] <= 0xD7:
                self.pos += 2
                return
            self.pos += 1
        raise StitchError("Expected restart marker, hit end of stream")


class _HuffDecoder:
    """Canonical Huffman decode table: (code,len) -> symbol via per-length
    min/max code arrays (the classic fast table walk)."""

    def __init__(self, bits: list[int], vals: bytes):
        self.min_code = [0] * 17
        self.max_code = [-1] * 17
        self.val_ptr = [0] * 17
        code = 0
        k = 0
        for length in range(1, 17):
            n = bits[length - 1]
            if n:
                self.val_ptr[length] = k
                self.min_code[length] = code
                code += n
                self.max_code[length] = code - 1
                k += n
            code <<= 1
        self.vals = vals

    def decode(self, br: _BitReader) -> int:
        code = br.bit()
        length = 1
        while length <= 16:
            if self.max_code[length] >= code >= self.min_code[length] and self.max_code[length] >= 0:
                return self.vals[self.val_ptr[length] + code - self.min_code[length]]
            code = (code << 1) | br.bit()
            length += 1
        raise StitchError("Invalid Huffman code in JPEG stream")


def _extend(v: int, size: int) -> int:
    """Sign-extend a magnitude-coded value (JPEG F.2.2.1)."""
    if size == 0:
        return 0
    return v if v >= (1 << (size - 1)) else v - (1 << size) + 1


def decode_baseline_jpeg(data: bytes) -> np.ndarray:
    """Decode a baseline or progressive JPEG to (H, W, 3) uint8 RGB
    (grayscale images are replicated across channels)."""
    try:
        return _decode_jpeg_impl(bytes(data))
    except StitchError:
        raise
    except (IndexError, ValueError, ZeroDivisionError) as exc:
        # Hostile/truncated streams must never leak parser internals
        # (fuzz-found: truncated DHT/SOS bodies raised IndexError).
        raise StitchError("Invalid JPEG: malformed stream", exc) from exc


def _decode_jpeg_impl(data: bytes) -> np.ndarray:
    width, height, comps, qtables = _decode_to_coefficients(bytes(data))
    return _finish_decode(width, height, comps, qtables)


def decode_coefficients(data: bytes):
    """Host Huffman stage only — the device decode tier's input (SURVEY
    build-plan step 6: host Huffman decode -> TPU dequant/IDCT/upsample/
    color; ops/jpeg_idct_device consumes these).

    Returns (blocks, qtabs, geom, width, height): per component,
    ``blocks`` (by*bx, 64) int32 natural-order quantized coefficients,
    ``qtabs`` (64,) int32 natural-order quant table, and ``geom``
    (by, bx, comp_w, comp_h, h_expand, v_expand) static tuples matching
    ops/jpeg_idct_device.decode_rgb_trace.
    """
    try:
        width, height, comps, qtables = _decode_to_coefficients(bytes(data))
    except StitchError:
        raise
    except (IndexError, ValueError, ZeroDivisionError) as exc:
        raise StitchError("Invalid JPEG: malformed stream", exc) from exc
    qts, geom = _tables_and_geometry(width, height, comps, qtables)
    return [c.blocks for c in comps], qts, geom, width, height


@dataclass
class ZigzagCoefficients:
    """A baseline stream's coefficients as the native scan's zigzag store
    leaves them: per component, ``blocks`` (by*bx, 64) int16 in zigzag
    order, held in scratch of ``native.buffer_pool`` until ``release()``;
    ``last``, the highest nonzero zigzag position (-1: none); ``peak``, the
    largest |coefficient| (below 2^15). ``qtabs``, ``geom``, ``width`` and
    ``height`` as ``decode_coefficients`` gives them."""

    blocks: list
    last: list
    peak: list
    qtabs: list
    geom: list
    width: int
    height: int
    scratch: list = field(default_factory=list, repr=False)

    def release(self) -> None:
        """Hand the blocks' scratch back to the pool; the blocks are gone."""
        _release(self.scratch)
        self.scratch, self.blocks = [], []


def _release(scratch: list) -> None:
    from ...native import buffer_pool

    for buf in scratch:
        buffer_pool.put(buf)


def decode_zigzag_coefficients(data: bytes) -> ZigzagCoefficients | None:
    """The host Huffman stage of a baseline (SOF0/SOF1) stream, through the
    native scan's zigzag store: coefficients in zigzag order as int16, and
    the figures the device tier's transport needs, gathered as the scan
    stores them. None for a stream the store does not take (progressive,
    the native tier absent, a component scanned twice or never, a value at
    or past 2^15): ``decode_coefficients`` decodes it."""
    scratch: list[np.ndarray] = []
    kept = False
    try:
        try:
            width, height, comps, qtables = _decode_to_coefficients(bytes(data), scratch)
        except (IndexError, ValueError, ZeroDivisionError) as exc:
            raise StitchError("Invalid JPEG: malformed stream", exc) from exc
        if any(c.last is None or c.peak >= 1 << 15 for c in comps):
            return None
        qts, geom = _tables_and_geometry(width, height, comps, qtables)
        kept = True
        return ZigzagCoefficients(
            [c.blocks for c in comps], [c.last for c in comps], [c.peak for c in comps],
            qts, geom, width, height, scratch)
    except _NaturalRoute:
        return None
    finally:
        if not kept:
            _release(scratch)


def _tables_and_geometry(width, height, comps, qtables):
    """Per component, its natural-order quantizer table and its
    (by, bx, comp_w, comp_h, h_expand, v_expand)."""
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    qts, geom = [], []
    for c in comps:
        q = qtables.get(c.tq)
        if q is None:
            raise StitchError(f"Missing quantization table {c.tq}")
        comp_w = -(-width * c.h // hmax)
        comp_h = -(-height * c.v // vmax)
        geom.append((c.by, c.bx, comp_w, comp_h, hmax // c.h, vmax // c.v))
        qts.append(q)
    return qts, geom


def _decode_to_coefficients(data: bytes, scratch: list | None = None):
    """Walk the stream's markers and decode its scans into its components'
    blocks: natural-order int32, or, given ``scratch``, the zigzag store's
    int16 in buffers of ``native.buffer_pool``, each appended to
    ``scratch`` as it is taken (raises ``_NaturalRoute`` for a stream the
    store does not take)."""
    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        raise StitchError("Invalid JPEG: missing SOI")

    qtables: dict[int, np.ndarray] = {}
    dc_tables: dict[int, _HuffDecoder] = {}
    ac_tables: dict[int, _HuffDecoder] = {}
    comps: list[_Component] = []
    width = height = 0
    restart_interval = 0
    progressive = False
    saw_scan = False
    pos = 2

    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker in (0x01,) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        seg_len = (data[pos + 2] << 8) | data[pos + 3]
        body = data[pos + 4 : pos + 2 + seg_len]

        if marker == 0xDB:  # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 0x0F
                i += 1
                need = 128 if pq else 64
                if i + need > len(body):
                    raise StitchError("Invalid JPEG: truncated DQT segment")
                if pq:
                    vals = np.frombuffer(body[i : i + 128], dtype=">u2").astype(np.int32)
                    i += 128
                else:
                    vals = np.frombuffer(body[i : i + 64], dtype=np.uint8).astype(np.int32)
                    i += 64
                nat = np.empty(64, dtype=np.int32)
                nat[ZIGZAG] = vals  # stored zigzag -> natural order
                qtables[tq] = nat
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 0x0F
                i += 1
                if i + 16 > len(body):
                    raise StitchError("Invalid JPEG: truncated DHT segment")
                bits = list(body[i : i + 16])
                i += 16
                n = sum(bits)
                if i + n > len(body):
                    raise StitchError("Invalid JPEG: truncated DHT symbol table")
                vals = body[i : i + n]
                i += n
                table = _HuffDecoder(bits, vals)
                (ac_tables if tc else dc_tables)[th] = table
        elif marker in (0xC0, 0xC1, 0xC2):  # SOF0/1 baseline, SOF2 progressive
            progressive = marker == 0xC2
            if progressive and scratch is not None:
                raise _NaturalRoute
            precision = body[0]
            if precision != 8:
                raise StitchError(f"Unsupported JPEG precision: {precision}")
            if len(body) < 6:
                raise StitchError("Invalid JPEG: truncated SOF segment")
            height = (body[1] << 8) | body[2]
            width = (body[3] << 8) | body[4]
            nc = body[5]
            if len(body) < 6 + nc * 3:
                raise StitchError("Invalid JPEG: truncated SOF component list")
            comps = []
            for c in range(nc):
                cid, hv, tq = body[6 + c * 3], body[7 + c * 3], body[8 + c * 3]
                h, v = hv >> 4, hv & 0x0F
                if not (1 <= h <= 4 and 1 <= v <= 4):
                    raise StitchError(
                        f"Invalid JPEG: component {cid} sampling factors "
                        f"{h}x{v} out of range 1..4"
                    )
                comps.append(_Component(cid, h, v, tq))
        elif marker in (0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF):
            raise StitchError(
                "Owned JPEG decoder supports baseline sequential and "
                f"progressive only (got SOF marker 0xFF{marker:02X}); install "
                "PIL for lossless/arithmetic/hierarchical JPEGs"
            )
        elif marker == 0xDD:  # DRI
            if len(body) < 2:
                raise StitchError("Invalid JPEG: truncated DRI segment")
            restart_interval = (body[0] << 8) | body[1]
        elif marker == 0xDA:  # SOS
            if not body:
                raise StitchError("Invalid JPEG: empty SOS segment")
            ns = body[0]
            if len(body) < 1 + ns * 2 + 3:
                raise StitchError("Invalid JPEG: truncated SOS segment")
            order: list[_Component] = []
            for c in range(ns):
                cs, tdta = body[1 + c * 2], body[2 + c * 2]
                comp = next((x for x in comps if x.comp_id == cs), None)
                if comp is None:
                    raise StitchError(
                        f"Invalid JPEG: scan references unknown component id {cs}"
                    )
                comp.td, comp.ta = tdta >> 4, tdta & 0x0F
                order.append(comp)
            scan_start = pos + 2 + seg_len
            if not comps or width == 0 or height == 0:
                raise StitchError("Invalid JPEG: missing SOF before SOS")
            if comps[0].blocks is None:
                hmax = max(c.h for c in comps)
                vmax = max(c.v for c in comps)
                mcux = -(-width // (8 * hmax))
                mcuy = -(-height // (8 * vmax))
                for c in comps:
                    c.bx = mcux * c.h
                    c.by = mcuy * c.v
                    if scratch is None:
                        c.blocks = np.zeros((c.by * c.bx, 64), dtype=np.int32)
                    else:
                        from ...native import buffer_pool

                        scratch.append(buffer_pool.get(c.by * c.bx * 128))
                        c.blocks = scratch[-1].view(np.int16).reshape(-1, 64)
            # Scans accumulate coefficients into the persistent per-
            # component arrays; _finish_decode runs once at EOI. Baseline
            # sequential images may carry SEVERAL scans too (T.81 A.2
            # non-interleaved scan scripts, e.g. one SOS per component) —
            # the common single-scan file takes the same path and just
            # finds EOI right after its scan.
            if not progressive:
                end = _decode_scan(
                    data, scan_start, width, height, comps, order,
                    dc_tables, ac_tables, restart_interval, scratch is not None,
                )
                if end is None:
                    end = _next_marker_pos(data, scan_start)
            else:
                # Progressive: T.81 G.2; reference parity:
                # jpeg-decoder.ts:250-262 via jpeg-js decodeScan
                # successive approximation.
                ss, se = body[1 + 2 * ns], body[2 + 2 * ns]
                ah, al = body[3 + 2 * ns] >> 4, body[3 + 2 * ns] & 0x0F
                end = _decode_progressive_scan(
                    data, scan_start, width, height, comps, order,
                    dc_tables, ac_tables, restart_interval, ss, se, ah, al,
                )
            saw_scan = True
            pos = end
            continue
        elif marker == 0xD9:
            break
        pos += 2 + seg_len
    if saw_scan:
        return width, height, comps, qtables
    raise StitchError("Invalid JPEG: no SOS marker found")


def _decode_scan(
    data, scan_start, width, height, comps, order,
    dc_tables, ac_tables, restart_interval, zigzag=False,
) -> int | None:
    """Decode one baseline scan into the components' (pre-allocated)
    coefficient arrays. ``order`` may be a subset of ``comps`` (multi-
    scan sequential files); a single-component scan is non-interleaved
    (T.81 A.2). ``zigzag``: the arrays are the zigzag store's, which only
    the native scan fills (else ``_NaturalRoute``); it also finds the next
    marker's position, which is returned (else None)."""
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))

    if zigzag:
        return _decode_scan_zigzag_native(
            data, scan_start, width, height, comps, order, dc_tables, ac_tables,
            mcux, mcuy, restart_interval,
        )
    if _decode_scan_native(
        data, scan_start, width, height, comps, order, dc_tables, ac_tables,
        mcux, mcuy, restart_interval,
    ):
        return None

    br = _BitReader(data, scan_start)
    preds = {c.comp_id: 0 for c in comps}
    mcu_count = 0

    # A scan with ONE component is non-interleaved (T.81 A.2 / libjpeg
    # jdinput.c): the data unit is a single block traversed over the
    # component's own block grid — no h x v sub-block grouping, no MCU
    # padding columns — and the restart interval counts BLOCKS. Gray
    # JPEGs written with sampling factors > 1 (PIL subsampling=1/2)
    # decode wrong under MCU traversal (found by the session-5 soak).
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    if len(order) == 1:
        c = order[0]
        comp_w = -(-width * c.h // hmax)
        comp_h = -(-height * c.v // vmax)
        wb, hb = -(-comp_w // 8), -(-comp_h // 8)
        units = [(c, my, mx) for my in range(hb) for mx in range(wb)]
    else:
        units = [(None, my, mx) for my in range(mcuy) for mx in range(mcux)]

    for uc, my, mx in units:
        if restart_interval and mcu_count and mcu_count % restart_interval == 0:
            br.sync_restart()
            for cid in preds:
                preds[cid] = 0
        scan_units = (
            [(uc, my, mx, 1, 1)]
            if uc is not None
            else [(c, my, mx, c.v, c.h) for c in order]
        )
        for c, my_u, mx_u, nv, nh in scan_units:
            dc_t = dc_tables.get(c.td)
            ac_t = ac_tables.get(c.ta)
            if dc_t is None or ac_t is None:
                raise StitchError("Missing Huffman table for scan")
            for v in range(nv):
                for hh in range(nh):
                    bx = mx_u * nh + hh
                    by = my_u * nv + v
                    blk = c.blocks[by * c.bx + bx]
                    s = dc_t.decode(br)
                    diff = _extend(br.bits(s), s)
                    preds[c.comp_id] += diff
                    blk[0] = preds[c.comp_id]
                    k = 1
                    while k < 64:
                        rs = ac_t.decode(br)
                        r, size = rs >> 4, rs & 0x0F
                        if size == 0:
                            if r == 15:
                                k += 16
                                continue
                            break  # EOB
                        k += r
                        if k > 63:
                            raise StitchError("AC coefficient index out of range")
                        blk[ZIGZAG[k]] = _extend(br.bits(size), size)
                        k += 1
        mcu_count += 1


def _next_marker_pos(data: bytes, pos: int) -> int:
    """Position of the next non-RST, non-stuffing marker at/after ``pos``
    (entropy-coded data only ever contains 0xFF00 and RSTn)."""
    n = len(data)
    while True:
        # bytes.find skips the entropy-coded bytes in C: a byte-at-a-time
        # Python loop here took longer than the native Huffman decode.
        pos = data.find(b"\xff", pos)
        if pos < 0 or pos + 1 >= n:
            return n
        nxt = data[pos + 1]
        if nxt != 0x00 and not 0xD0 <= nxt <= 0xD7:
            return pos
        pos += 1


def _decode_progressive_scan(
    data, scan_start, width, height, comps, order,
    dc_tables, ac_tables, restart_interval, ss, se, ah, al,
) -> int:
    """Decode one progressive scan into the components' coefficient arrays
    (T.81 G.2: DC/AC first scans and successive-approximation refinements;
    structure mirrors libjpeg jdphuff.c). Returns the stream position of the
    marker following the scan.

    The C++ tier (jpeg_decode_progressive_scan, same buffered reader as
    the baseline scan) runs the scan when available; this Python body is
    the fallback and parity oracle (fuzzed against it)."""
    if _decode_progressive_scan_native(
        data, scan_start, width, height, comps, order,
        dc_tables, ac_tables, restart_interval, ss, se, ah, al,
    ):
        return _next_marker_pos(data, scan_start)
    br = _BitReader(data, scan_start)
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    eobrun = 0
    p1 = 1 << al
    m1 = -p1

    def refine_nonzero(blk, z) -> None:
        if br.bit():
            if (blk[z] & p1) == 0:
                blk[z] += p1 if blk[z] >= 0 else m1

    def decode_ac_first(blk) -> None:
        nonlocal eobrun
        if eobrun > 0:
            eobrun -= 1
            return
        k = ss
        while k <= se:
            rs = ac_t.decode(br)
            r, s = rs >> 4, rs & 0x0F
            if s == 0:
                if r < 15:
                    eobrun = (1 << r) - 1
                    if r:
                        eobrun += br.bits(r)
                    return
                k += 16
                continue
            k += r
            if k > se:
                raise StitchError("AC coefficient index out of range")
            blk[ZIGZAG[k]] = _extend(br.bits(s), s) << al
            k += 1

    def decode_ac_refine(blk) -> None:
        nonlocal eobrun
        k = ss
        if eobrun == 0:
            while k <= se:
                rs = ac_t.decode(br)
                r, s = rs >> 4, rs & 0x0F
                val = 0
                if s == 0:
                    if r < 15:
                        eobrun = (1 << r)
                        if r:
                            eobrun += br.bits(r)
                        break
                    # r == 15: pass over 16 zero-history coefficients
                else:
                    # s is always 1 in refinement scans
                    val = p1 if br.bit() else m1
                while k <= se:
                    z = ZIGZAG[k]
                    if blk[z] != 0:
                        refine_nonzero(blk, z)
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if val and k <= se:
                    blk[ZIGZAG[k]] = val
                k += 1
        if eobrun > 0:
            while k <= se:
                z = ZIGZAG[k]
                if blk[z] != 0:
                    refine_nonzero(blk, z)
                k += 1
            eobrun -= 1

    preds = {c.comp_id: 0 for c in comps}

    def restart_sync() -> None:
        nonlocal eobrun
        br.sync_restart()
        eobrun = 0
        for cid in preds:
            preds[cid] = 0

    if ss == 0:
        if se != 0:
            raise StitchError("Invalid progressive scan: DC scan with Se != 0")
        # DC scans are interleaved (MCU order) only with >1 component in
        # the scan; a single-component scan is ALWAYS non-interleaved
        # (T.81 A.2) — one block per data unit over the component's own
        # block grid, restarts counted in blocks. This matters for
        # single-component images whose SOF carries sampling factors > 1
        # (PIL writes gray with the requested subsampling's factors).
        unit_count = 0
        if len(order) > 1:
            iterspace = [(my, mx) for my in range(mcuy) for mx in range(mcux)]
            for my, mx in iterspace:
                if restart_interval and unit_count and unit_count % restart_interval == 0:
                    restart_sync()
                for c in order:
                    for v in range(c.v):
                        for hh in range(c.h):
                            blk = c.blocks[(my * c.v + v) * c.bx + (mx * c.h + hh)]
                            if ah == 0:
                                dc_t = dc_tables.get(c.td)
                                if dc_t is None:
                                    raise StitchError("Missing DC Huffman table")
                                s = dc_t.decode(br)
                                preds[c.comp_id] += _extend(br.bits(s), s)
                                blk[0] = preds[c.comp_id] << al
                            else:
                                blk[0] |= br.bit() << al
                unit_count += 1
        else:
            c = order[0]
            comp_w = -(-width * c.h // hmax)
            comp_h = -(-height * c.v // vmax)
            wb, hb = -(-comp_w // 8), -(-comp_h // 8)
            for by in range(hb):
                for bx in range(wb):
                    if restart_interval and unit_count and unit_count % restart_interval == 0:
                        restart_sync()
                    blk = c.blocks[by * c.bx + bx]
                    if ah == 0:
                        dc_t = dc_tables.get(c.td)
                        if dc_t is None:
                            raise StitchError("Missing DC Huffman table")
                        s = dc_t.decode(br)
                        preds[c.comp_id] += _extend(br.bits(s), s)
                        blk[0] = preds[c.comp_id] << al
                    else:
                        blk[0] |= br.bit() << al
                    unit_count += 1
    else:
        # AC scans are always single-component (T.81 G.1.1.1).
        if len(order) != 1:
            raise StitchError("Invalid progressive scan: interleaved AC scan")
        c = order[0]
        ac_t = ac_tables.get(c.ta)
        if ac_t is None:
            raise StitchError("Missing AC Huffman table")
        comp_w = -(-width * c.h // hmax)
        comp_h = -(-height * c.v // vmax)
        wb, hb = -(-comp_w // 8), -(-comp_h // 8)
        unit_count = 0
        for by in range(hb):
            for bx in range(wb):
                if restart_interval and unit_count and unit_count % restart_interval == 0:
                    restart_sync()
                blk = c.blocks[by * c.bx + bx]
                if ah == 0:
                    decode_ac_first(blk)
                else:
                    decode_ac_refine(blk)
                unit_count += 1

    return _next_marker_pos(data, scan_start)


def _decode_progressive_scan_native(
    data, scan_start, width, height, comps, order,
    dc_tables, ac_tables, restart_interval, ss, se, ah, al,
) -> bool:
    """Run one progressive scan through the C++ tier; False -> python
    fallback (native tier absent, >4 scan components, or a Huffman table
    the scan needs is missing — the Python body raises the precise
    diagnostic)."""
    try:
        from ...native import jpeg_decode_progressive_scan_native, native_available

        if not native_available() or len(order) > 4:
            return False
        if ss == 0 and ah == 0:
            for c in order:
                if c.td not in dc_tables:
                    return False
        if ss > 0:
            if len(order) != 1 or order[0].ta not in ac_tables:
                return False
        dc_slots, ac_slots = _huff_slots(dc_tables), _huff_slots(ac_tables)
        hmax = max(c.h for c in comps)
        vmax = max(c.v for c in comps)
        mcux = -(-width // (8 * hmax))
        mcuy = -(-height // (8 * vmax))
        # Single-component scans are NON-interleaved even when the image
        # has one component with sampling factors > 1 (T.81 A.2; the
        # session-5 soak caught gray 2x1 images decoding MCU-padded).
        interleaved = ss == 0 and len(order) > 1
        geo = []
        blocks = []
        for c in order:
            comp_w = -(-width * c.h // hmax)
            comp_h = -(-height * c.v // vmax)
            geo.append((c.h, c.v, c.bx, -(-comp_w // 8), -(-comp_h // 8)))
            if not (
                isinstance(c.blocks, np.ndarray)
                and c.blocks.dtype == np.int32
                and c.blocks.flags.c_contiguous
            ):  # pragma: no cover - blocks are always np.zeros int32
                return False
            blocks.append(c.blocks)
        return jpeg_decode_progressive_scan_native(
            bytes(data), scan_start, geo, dc_slots, ac_slots,
            [c.td for c in order], [c.ta for c in order],
            mcux, mcuy, restart_interval, interleaved, ss, se, ah, al,
            blocks,
        )
    except ImportError:  # pragma: no cover
        return False


def _decode_scan_native(
    data, scan_start, width, height, comps, order, dc_tables, ac_tables,
    mcux, mcuy, restart_interval,
) -> bool:
    """Run the scan through the C++ tier; False -> python fallback."""
    try:
        from ...native import jpeg_decode_scan_native, native_available

        if not native_available() or len(order) > 3:
            return False
        dc_slots, ac_slots = _huff_slots(dc_tables), _huff_slots(ac_tables)
        for c in order:
            if c.td not in dc_tables or c.ta not in ac_tables:
                return False
        blocks = [np.ascontiguousarray(c.blocks, dtype=np.int32) for c in order]
        hmax = max(c.h for c in comps)
        vmax = max(c.v for c in comps)

        def grid(c):
            comp_w = -(-width * c.h // hmax)
            comp_h = -(-height * c.v // vmax)
            return (-(-comp_w // 8), -(-comp_h // 8))

        ok = jpeg_decode_scan_native(
            bytes(data[scan_start:]),
            [(c.h, c.v, c.bx) + grid(c) for c in order],
            dc_slots,
            ac_slots,
            [c.td for c in order],
            [c.ta for c in order],
            mcux,
            mcuy,
            restart_interval,
            blocks,
        )
        if not ok:
            return False
        for c, b in zip(order, blocks):
            c.blocks = b
        return True
    except ImportError:  # pragma: no cover
        return False


def _huff_slots(tables: dict) -> list:
    """The four table slots of the native scans, from a scan's tables."""
    from ...native import HuffDecTableC, make_huff_dec_table

    slots = [HuffDecTableC() for _ in range(4)]
    for idx, t in tables.items():
        if 0 <= idx < 4:
            slots[idx] = make_huff_dec_table(t.min_code, t.max_code, t.val_ptr, t.vals)
    return slots


def _decode_scan_zigzag_native(
    data, scan_start, width, height, comps, order, dc_tables, ac_tables,
    mcux, mcuy, restart_interval,
) -> int:
    """Run the scan through the C++ tier's zigzag store into the components'
    int16 scratch, and keep each component's figures; returns the position
    of the marker after the scan. ``_NaturalRoute`` where the store cannot
    take the scan."""
    from ...native import jpeg_decode_scan_zigzag_native, native_available

    if not native_available() or len(order) > 3 or any(c.last is not None for c in order):
        raise _NaturalRoute
    if any(c.td not in dc_tables or c.ta not in ac_tables for c in order):
        raise _NaturalRoute  # the Python scan raises the precise diagnostic
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)

    def grid(c):  # the component's true block columns and rows
        return -(-(-(-width * c.h // hmax)) // 8), -(-(-(-height * c.v // vmax)) // 8)

    geo = [(c.h, c.v, c.bx) + grid(c) + (c.by,) for c in order]
    stats, end = jpeg_decode_scan_zigzag_native(
        data, scan_start, geo, _huff_slots(dc_tables), _huff_slots(ac_tables),
        [c.td for c in order], [c.ta for c in order], mcux, mcuy, restart_interval,
        [c.blocks for c in order])
    for c, (last, peak) in zip(order, stats.tolist()):
        c.last, c.peak = last, peak
    return end


def _finish_decode(width, height, comps, qtables) -> np.ndarray:
    """Dequantize + IDCT + upsample + color-convert, bit-identical to
    libjpeg (islow IDCT, fancy upsampling, fixed-point YCbCr->RGB — see
    codecs/jpeg/libjpeg_exact.py). The C++ tier runs the dequant+IDCT and
    the color convert (same int64 ops and tables — bit-identical, ~20x:
    the numpy tier's int64 multiplies don't SIMD); numpy is the fallback
    and stays the oracle in tests."""
    from .libjpeg_exact import idct_islow_blocks, upsample_plane, ycc_to_rgb

    try:
        from ...native import (
            jpeg_fancy_upsample_native,
            jpeg_idct_plane_native,
            jpeg_ycc_rgb_native,
        )
    except ImportError:  # pragma: no cover
        jpeg_idct_plane_native = jpeg_ycc_rgb_native = lambda *a: None
        jpeg_fancy_upsample_native = lambda *a: None

    vmax = max(c.v for c in comps)
    hmax = max(c.h for c in comps)
    planes = []
    for c in comps:
        q = qtables.get(c.tq)
        if q is None:
            raise StitchError(f"Missing quantization table {c.tq}")
        plane = jpeg_idct_plane_native(c.blocks, q, c.by, c.bx)
        if plane is None:
            coefs = (c.blocks.astype(np.int64) * q[None, :]).reshape(-1, 8, 8)
            pix = idct_islow_blocks(coefs)
            plane = (
                pix.reshape(c.by, c.bx, 8, 8)
                .transpose(0, 2, 1, 3)
                .reshape(c.by * 8, c.bx * 8)
            )
        # Crop to the component's real (downsampled) size before upsampling:
        # libjpeg's fancy filters replicate at the true edge, not the MCU
        # padding (jdsample.c uses downsampled_width).
        comp_w = -(-width * c.h // hmax)
        comp_h = -(-height * c.v // vmax)
        plane = plane[:comp_h, :comp_w]
        h_exp, v_exp = hmax // c.h, vmax // c.v
        if h_exp != 1 or v_exp != 1:
            # Fancy filters only at downsampled_width > 2 (libjpeg
            # jinit_upsampler); narrower planes replicate.
            up = (
                jpeg_fancy_upsample_native(plane, h_exp, v_exp)
                if plane.shape[1] > 2
                else None
            )
            plane = up if up is not None else upsample_plane(
                plane, h_exp, v_exp
            )
        planes.append(plane[:height, :width])

    if len(planes) == 1:
        g = planes[0]
        return np.stack([g, g, g], axis=-1)
    if len(planes) != 3:
        raise StitchError(f"Unsupported JPEG component count: {len(planes)}")
    rgb = jpeg_ycc_rgb_native(planes[0], planes[1], planes[2])
    if rgb is not None:
        return rgb
    return ycc_to_rgb(planes[0], planes[1], planes[2])
