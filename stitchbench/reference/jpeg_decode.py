"""Plain NumPy baseline JPEG reader with libjpeg's default decode arithmetic.

What a tile's pixels are when a camera-made JPEG is read: Huffman decode of
one baseline scan without restart markers, dequantization, libjpeg's
accurate integer IDCT (jidctint ``jpeg_idct_islow``, with its range-limit
table), fancy (triangular) upsampling of 4:2:0 or 4:2:2 chroma (jdsample)
and fixed-point YCbCr to RGB (jdcolor). Written from T.81 and the IJG
sources' arithmetic; the Huffman decode is a plain loop over symbols on a
table of 16-bit windows.
"""

from __future__ import annotations

import numpy as np

from stitchbench.reference.jpeg import ZIGZAG

CONST_BITS = 13
PASS1_BITS = 2
_FIX = dict(a=2446, b=3196, c=4433, d=6270, e=7373, f=9633, g=12299, h=15137,
            i=16069, j=16819, k=20995, l=25172)


def _segments(data: bytes):
    """(marker, payload) up to SOS, then ("scan", entropy-coded bytes)."""
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError("marker expected")
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        n = int.from_bytes(data[pos + 2: pos + 4], "big")
        payload = data[pos + 4: pos + 2 + n]
        yield marker, payload
        pos += 2 + n
        if marker == 0xDA:
            end = data.rfind(b"\xff\xd9")
            yield "scan", data[pos:end]
            return


def _huffman_table(counts, symbols) -> tuple[list[int], list[int]]:
    """Lookup over 16-bit windows: (code length, symbol) of each window."""
    lengths = np.zeros(1 << 16, np.int64)
    values = np.zeros(1 << 16, np.int64)
    code = k = 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            lo = code << (16 - length)
            hi = (code + 1) << (16 - length)
            lengths[lo:hi] = length
            values[lo:hi] = symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lengths.tolist(), values.tolist()


def _windows(scan: bytes) -> list[int]:
    """The unstuffed entropy bits as the 16-bit window at every bit
    position."""
    raw = np.frombuffer(scan, np.uint8)
    keep = np.ones(len(raw), bool)
    keep[np.flatnonzero(raw[:-1] == 0xFF) + 1] = False          # stuffed zeros
    body = np.concatenate([raw[keep], np.zeros(4, np.uint8)]).astype(np.int64)
    pos = np.arange((len(body) - 4) * 8)
    byte, bit = pos >> 3, pos & 7
    w24 = (body[byte] << 16) | (body[byte + 1] << 8) | body[byte + 2]
    return ((w24 >> (8 - bit)) & 0xFFFF).tolist()


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def decode_coefficients(data: bytes):
    """Quantized coefficients of each component, (rows, cols, 64) natural
    order, and the frame: (width, height, components, quant tables)."""
    qt, dc_t, ac_t = {}, {}, {}
    comps = []
    for marker, payload in _segments(data):
        if marker == 0xDB:
            p = 0
            while p < len(payload):
                tid = payload[p] & 15
                q = np.zeros(64, np.int64)
                q[ZIGZAG] = np.frombuffer(payload[p + 1: p + 65], np.uint8)
                qt[tid] = q
                p += 65
        elif marker == 0xC0:
            height = int.from_bytes(payload[1:3], "big")
            width = int.from_bytes(payload[3:5], "big")
            for c in range(payload[5]):
                cid, hv, tq = payload[6 + 3 * c: 9 + 3 * c]
                comps.append({"id": cid, "h": hv >> 4, "v": hv & 15, "tq": tq})
        elif marker == 0xC4:
            p = 0
            while p < len(payload):
                tc, th = payload[p] >> 4, payload[p] & 15
                counts = list(payload[p + 1: p + 17])
                n = sum(counts)
                table = _huffman_table(counts, list(payload[p + 17: p + 17 + n]))
                (dc_t if tc == 0 else ac_t)[th] = table
                p += 17 + n
        elif marker == 0xDD:
            raise ValueError("the reader takes no restart markers")
        elif marker == 0xDA:
            for k in range(payload[0]):
                cid, tables = payload[1 + 2 * k], payload[2 + 2 * k]
                comp = next(c for c in comps if c["id"] == cid)
                comp["td"], comp["ta"] = tables >> 4, tables & 15
        elif marker == "scan":
            scan = payload
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    coefs = [np.zeros((mcuy * c["v"], mcux * c["h"], 64), np.int64) for c in comps]
    win = _windows(scan)
    pos, pred = 0, [0] * len(comps)
    for m in range(mcux * mcuy):
        my, mx = divmod(m, mcux)
        for ci, c in enumerate(comps):
            dl, dv = dc_t[c["td"]]
            al, av = ac_t[c["ta"]]
            for by in range(c["v"]):
                for bx in range(c["h"]):
                    blk = np.zeros(64, np.int64)
                    w = win[pos]
                    pos += dl[w]
                    s = dv[w]
                    if s:
                        pred[ci] += _extend(win[pos] >> (16 - s), s)
                        pos += s
                    blk[0] = pred[ci]
                    k = 1
                    while k < 64:
                        w = win[pos]
                        pos += al[w]
                        rs = av[w]
                        r, s = rs >> 4, rs & 15
                        if s == 0:
                            if r != 15:
                                break
                            k += 16
                            continue
                        k += r
                        blk[ZIGZAG[k]] = _extend(win[pos] >> (16 - s), s)
                        pos += s
                        k += 1
                    coefs[ci][my * c["v"] + by, mx * c["h"] + bx] = blk
    return coefs, (width, height, comps, qt)


def _pass(x: np.ndarray, shift: int) -> np.ndarray:
    """One jidctint pass along axis 1 of (N, 8, M) int64."""
    i = [x[:, r] for r in range(8)]
    z1 = (i[2] + i[6]) * _FIX["c"]
    tmp2, tmp3 = z1 - i[6] * _FIX["h"], z1 + i[2] * _FIX["d"]
    tmp0, tmp1 = (i[0] + i[4]) << CONST_BITS, (i[0] - i[4]) << CONST_BITS
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = i[7], i[5], i[3], i[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _FIX["f"]
    t0, t1, t2, t3 = t0 * _FIX["a"], t1 * _FIX["j"], t2 * _FIX["l"], t3 * _FIX["g"]
    z1, z2 = z1 * -_FIX["e"], z2 * -_FIX["k"]
    z3, z4 = z3 * -_FIX["i"] + z5, z4 * -_FIX["b"] + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    outs = [t10 + t3, t11 + t2, t12 + t1, t13 + t0, t13 - t0, t12 - t1, t11 - t2, t10 - t3]
    return np.stack([(o + (1 << (shift - 1))) >> shift for o in outs], axis=1)


def _range_limit() -> np.ndarray:
    """jdmaster's post-IDCT table, indexed by (value & 1023)."""
    t = np.zeros(1024, np.uint8)
    t[:128] = np.arange(128, 256)
    t[128:512] = 255
    t[1024 - 128:] = np.arange(128)
    return t


_LIMIT = _range_limit()


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """(N, 8, 8) dequantized coefficients [row, col] -> (N, 8, 8) uint8."""
    ws = _pass(coef, CONST_BITS - PASS1_BITS)                       # columns
    out = _pass(np.swapaxes(ws, 1, 2), CONST_BITS + PASS1_BITS + 3)
    return _LIMIT[np.swapaxes(out, 1, 2) & 1023]


def _fancy_h2v2(p: np.ndarray) -> np.ndarray:
    p = p.astype(np.int64)
    out = np.empty((p.shape[0] * 2, p.shape[1] * 2), np.int64)
    for phase, adj in ((0, np.vstack([p[:1], p[:-1]])), (1, np.vstack([p[1:], p[-1:]]))):
        col = 3 * p + adj
        left = np.hstack([col[:, :1], col[:, :-1]])
        right = np.hstack([col[:, 1:], col[:, -1:]])
        rows = out[phase::2]
        rows[:, 0::2] = (3 * col + left + 8) >> 4
        rows[:, 1::2] = (3 * col + right + 7) >> 4
        rows[:, 0] = (4 * col[:, 0] + 8) >> 4
        rows[:, -1] = (4 * col[:, -1] + 7) >> 4
    return out


def _fancy_h2v1(p: np.ndarray) -> np.ndarray:
    p = p.astype(np.int64)
    out = np.empty((p.shape[0], p.shape[1] * 2), np.int64)
    out[:, 0::2] = (3 * p + np.hstack([p[:, :1], p[:, :-1]]) + 1) >> 2
    out[:, 1::2] = (3 * p + np.hstack([p[:, 1:], p[:, -1:]]) + 2) >> 2
    out[:, 0], out[:, -1] = p[:, 0], p[:, -1]
    return out


def _ycc_rgb(y, cb, cr) -> np.ndarray:
    fix = lambda x: int(x * 65536 + 0.5)                         # noqa: E731
    half = 1 << 15
    cb, cr, y = cb.astype(np.int64) - 128, cr.astype(np.int64) - 128, y.astype(np.int64)
    r = y + ((fix(1.40200) * cr + half) >> 16)
    g = y + ((-fix(0.34414) * cb + half - fix(0.71414) * cr) >> 16)
    b = y + ((fix(1.77200) * cb + half) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode(data: bytes) -> np.ndarray:
    """A baseline three-component JPEG -> (H, W, 4) uint8, alpha 255."""
    coefs, (width, height, comps, qt) = decode_coefficients(data)
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    planes = []
    for c, k in zip(comps, coefs):
        rows, cols = k.shape[:2]
        blocks = (k * qt[c["tq"]]).reshape(-1, 8, 8)
        px = idct_islow(blocks).reshape(rows, cols, 8, 8).transpose(0, 2, 1, 3)
        px = px.reshape(rows * 8, cols * 8)
        ph = -(-height * c["v"] // vmax)
        pw = -(-width * c["h"] // hmax)
        px = px[:ph, :pw]
        if (hmax // c["h"], vmax // c["v"]) == (2, 2) and pw > 2:
            px = _fancy_h2v2(px)
        elif (hmax // c["h"], vmax // c["v"]) == (2, 1) and pw > 2:
            px = _fancy_h2v1(px)
        else:
            px = np.repeat(np.repeat(px, vmax // c["v"], 0), hmax // c["h"], 1)
        planes.append(px[:height, :width])
    out = np.empty((height, width, 4), np.uint8)
    out[..., :3] = _ycc_rgb(*planes)
    out[..., 3] = 255
    return out
