"""The JPEG kernels' own arithmetic against their plain torch versions.

csrc/idct.cuh, ycc.cuh, fdct_quant.cuh and symbols.cuh, compiled by g++
into the serial host shim (csrc/host_shim.cpp), run the per-block and
per-pixel bodies that the CUDA kernels run, split as the kernels split
them: ``idct_dequant_host`` runs the 8 column passes of a block into a
workspace and then its 8 row passes; ``symbol_streams_host`` finds each
block's component and its DC predecessor as a kernel thread does. Each is
held against the plain version the CPU path uses, bit for bit. The wrappers'
checks and launch counts are tested here too (the CPU path never launches).
"""

import ctypes

import numpy as np
import pytest
import torch

from image_stitch_tpu_torch._build import load_host_shim
from image_stitch_tpu_torch.codecs.jpeg.device_decoder import _band_window
from image_stitch_tpu_torch.codecs.jpeg.tables import ZIGZAG, quality_scaled_tables
from image_stitch_tpu_torch.ops import jpeg_entropy_device as E
from image_stitch_tpu_torch.ops import jpeg_idct_device as D
from image_stitch_tpu_torch.ops import kernels as K
from image_stitch_tpu_torch.ops.jpeg_dct import quantize_islow
from tests.utils.torch_port import TABLES

torch.set_num_threads(1)


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data_as(ctypes.c_void_p).value


def _q_table(quality: int) -> np.ndarray:
    return quality_scaled_tables(quality)[0].astype(np.int32)


# --------------------------------------------------------------------------- #
# idct_dequant
# --------------------------------------------------------------------------- #


def shim_idct(zz: np.ndarray, q: np.ndarray, bx: int) -> np.ndarray:
    zz, q = np.ascontiguousarray(zz, np.int16), np.ascontiguousarray(q, np.int32)
    n, k = zz.shape
    out = np.zeros((n // bx * 8, bx * 8), np.uint8)
    load_host_shim().idct_dequant_host(_ptr(zz), n, k, _ptr(q), bx, _ptr(out))
    return out


# (k, q): K = 1, 8, 24 and 64 (the bucketed zigzag prefix), with the q50 and
# q100 tables and a random 16-bit table.
IDCT_CASES = [(1, "q50"), (8, "q50"), (24, "q100"), (64, "q50"), (64, "q100"), (40, "random")]


@pytest.mark.parametrize("k,qname", IDCT_CASES)
def test_idct_bodies_match_plain_over_the_int16_range(k, qname):
    """Coefficients over all of int16 (the decoder's transport), so the
    IDCT's outputs wrap through the range limit's whole 1024 cycle; one
    block row in five with all AC terms zero, and columns whose AC terms
    are zero."""
    rng = np.random.default_rng(k)
    q = (rng.integers(1, 1 << 16, 64) if qname == "random"
         else _q_table(50 if qname == "q50" else 100)).astype(np.int32)
    bx = 7
    zz = rng.integers(-(1 << 15), 1 << 15, (5 * bx, k)).astype(np.int16)
    zz[: bx, 1:] = 0  # DC only
    nat_cols = np.asarray(ZIGZAG[:k]) % 8
    zz[bx : 2 * bx, nat_cols == 3] = 0  # column 3 has no AC term
    got = shim_idct(zz, q, bx)
    want = D.decode_plane(torch.from_numpy(zz), torch.from_numpy(q), bx).numpy()
    np.testing.assert_array_equal(got, want)
    if k == 64:
        # The raw IDCT outputs reach every arm of the range limit.
        raw = D.idct_islow(D.dequantize(D.dezigzag_pad(torch.from_numpy(zz), k),
                                        torch.from_numpy(q)).reshape(-1, 8, 8)) & 1023
        assert all(bool(((raw >= lo) & (raw < hi)).any())
                   for lo, hi in ((0, 128), (128, 512), (512, 896), (896, 1024)))


def test_range_limit_is_a_wrap():
    x = torch.arange(-3000, 3000, dtype=torch.int64)
    post = np.zeros(1024, np.uint8)
    post[:128] = np.arange(128, 256)
    post[128:512] = 255
    post[896:] = np.arange(128)
    np.testing.assert_array_equal(D.range_limit(x).numpy(), post[x.numpy() & 1023])


# --------------------------------------------------------------------------- #
# ycc_rgba
# --------------------------------------------------------------------------- #


def shim_ycc(planes, geoms, out: np.ndarray, x0: int, width: int) -> np.ndarray:
    planes = [np.ascontiguousarray(p) for p in planes]
    rows = []
    for p, (h_exp, v_exp, r0, w0l, w1l, comp_w) in zip(planes, geoms):
        rows += [p.shape[1], h_exp, v_exp, r0, w0l, w1l - w0l, comp_w]
    ptrs = [_ptr(p) for p in planes] * (3 if len(planes) == 1 else 1)
    load_host_shim().ycc_rgba_host(*ptrs[:3], (ctypes.c_int32 * len(rows))(*rows), len(planes),
                                   _ptr(out), out.shape[1] * 4, x0, out.shape[0], width)
    return out


def window_case(rng, sampling: str, width: int, height: int, y0: int, y1: int, gray=False):
    """Random component planes of an image, cut to the band window of rows
    [y0, y1) as DeviceJpegDecoder cuts them."""
    hmax, vmax = {"444": (1, 1), "422": (2, 1), "420": (2, 2), "411": (4, 1),
                  "440": (1, 2)}[sampling]
    comps = [(hmax, vmax)] if gray else [(hmax, vmax), (1, 1), (1, 1)]
    planes, geoms = [], []
    for h, v in comps:
        comp_w, comp_h = -(-width * h // hmax), -(-height * v // vmax)
        by, bx = -(-comp_h // (8 * v)) * v, -(-comp_w // (8 * h)) * h
        h_exp, v_exp = hmax // h, vmax // v
        fancy_v = v_exp == 2 and h_exp == 2 and comp_w > 2
        wa, wb, r0 = _band_window(y0, y1, comp_h, v_exp, fancy_v)
        bb, be = wa // 8, min(by, -(-wb // 8))
        planes.append(rng.integers(0, 256, ((be - bb) * 8, bx * 8), dtype=np.uint8))
        geoms.append((h_exp, v_exp, r0, wa - bb * 8, wb - bb * 8, comp_w))
    return planes, geoms


# (sampling, width, height, y0, y1): the band at the image's top and bottom
# edges and inside it, odd widths, comp_w of 2 and 3 (integer and fancy
# upsampling), gray.
YCC_CASES = [("444", 37, 40, 8, 24), ("422", 37, 40, 0, 40), ("420", 45, 67, 0, 16),
             ("420", 45, 67, 16, 33), ("420", 45, 67, 33, 67), ("420", 4, 9, 1, 8),
             ("420", 6, 9, 3, 9), ("420", 5, 8, 0, 8), ("411", 30, 10, 2, 9),
             ("440", 30, 21, 5, 20), ("420gray", 33, 21, 4, 17)]


@pytest.mark.parametrize("sampling,width,height,y0,y1", YCC_CASES)
def test_ycc_bodies_match_plain(sampling, width, height, y0, y1):
    rng = np.random.default_rng(width * height + y0)
    gray = sampling.endswith("gray")
    planes, geoms = window_case(rng, sampling[:3], width, height, y0, y1, gray)
    band_w, x0 = width + 11, 5  # the tile inside a wider band
    out = np.zeros((y1 - y0, band_w, 4), np.uint8)
    got = shim_ycc(planes, geoms, out.copy(), x0, width)
    want = torch.from_numpy(out.copy())
    K.ycc_rgba([torch.from_numpy(p) for p in planes], geoms, want, x0, width)
    np.testing.assert_array_equal(got, want.numpy())
    assert (got[:, x0 : x0 + width, 3] == 255).all() and not got[:, :x0].any()


def test_ycc_colour_axes_exhaustive():
    """Every Y, Cb and Cr against mid-range others, and random triples,
    through the shim's colour arithmetic and the plain version."""
    rng = np.random.default_rng(5)
    sweep = np.arange(256, dtype=np.uint8)
    mid = np.full(256, 128, np.uint8)
    trip = [(sweep, mid, mid), (mid, sweep, mid), (mid, mid, sweep),
            tuple(rng.integers(0, 256, (3, 256), dtype=np.uint8))]
    planes = [np.stack([t[c] for t in trip]) for c in range(3)]  # (4, 256) each
    geoms = [(1, 1, 0, 0, 4, 256)] * 3
    got = shim_ycc(planes, geoms, np.zeros((4, 256, 4), np.uint8), 0, 256)
    want = D.window_to_rgba([torch.from_numpy(p) for p in planes], geoms, 4, 256)
    np.testing.assert_array_equal(got, want.numpy())


# --------------------------------------------------------------------------- #
# fdct_quant
# --------------------------------------------------------------------------- #


def shim_fdct(band: np.ndarray, lq: np.ndarray, cq: np.ndarray, sampling: str):
    band = np.ascontiguousarray(band)
    h, w, ch = band.shape
    n = (h // 8) * (w // 8)
    nc = n // 4 if sampling == "420" else n
    outs = [np.zeros((cnt, 64), np.int16) for cnt in (n, nc, nc)]
    load_host_shim().fdct_quant_host(_ptr(band), h, w, ch, _ptr(lq), _ptr(cq),
                                     int(sampling == "420"), *(_ptr(o) for o in outs))
    return outs


@pytest.mark.parametrize("sampling", ["444", "420"])
@pytest.mark.parametrize("kind", ["random", "blue", "gradient"])
@pytest.mark.parametrize("channels", [3, 4])
def test_fdct_bodies_match_plain(sampling, kind, channels):
    """Random bytes, saturated blue (Cb = 256, unclamped) and a smooth
    gradient, read with a pixel stride of 3 and 4 bytes."""
    rng = np.random.default_rng(channels)
    h, w = 32, 48
    if kind == "random":
        band = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
    elif kind == "blue":
        band = np.zeros((h, w, channels), np.uint8)
        band[..., 2] = 255
    else:
        band = np.broadcast_to(np.linspace(0, 255, w, dtype=np.uint8)[None, :, None],
                               (h, w, channels)).copy()
    for quality in (50, 100, 10):
        lq, cq = (t.astype(np.int32) for t in quality_scaled_tables(quality))
        got = shim_fdct(band, lq, cq, sampling)
        want = K.fdct_quant(torch.from_numpy(band), torch.from_numpy(lq), torch.from_numpy(cq),
                            sampling)
        for g, t in zip(got, want):
            np.testing.assert_array_equal(g, t.numpy())


def test_quantizer_at_every_rounding_edge():
    """c = k * 8q + 4q - 1, k * 8q + 4q and k * 8q + 4q + 1, both signs,
    for every q of 1..255: round half away from zero in both versions."""
    q = np.repeat(np.arange(1, 256, dtype=np.int32), 5 * 3 * 2)
    k = np.tile(np.repeat(np.arange(5, dtype=np.int32), 6), 255)
    d = np.tile(np.array([-1, 0, 1], np.int32).repeat(2), 255 * 5)
    sign = np.tile(np.array([1, -1], np.int32), 255 * 5 * 3)
    c = np.ascontiguousarray(sign * (k * 8 * q + 4 * q + d))
    got = np.zeros(c.shape, np.int16)
    load_host_shim().fdct_quantize_host(_ptr(c), _ptr(q), _ptr(got), c.size)
    want = quantize_islow(torch.from_numpy(c), torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.abs(got[d == 0]), k[d == 0] + 1)


# --------------------------------------------------------------------------- #
# symbol_streams
# --------------------------------------------------------------------------- #

LUTS = E.build_entropy_luts(*TABLES, "cpu")


def edge_blocks(rng, n: int) -> np.ndarray:
    """(n, 64) int16 natural-order blocks: random sparse ones, and the AC
    edges in zigzag order: runs of 15, 16, 17 and 32 zeros ended by a
    nonzero, a nonzero at position 63, runs of 16+ zeros to the end, all
    zeros, and values from 1 to 1023 in magnitude."""
    zz = rng.integers(-40, 41, (n, 64)) * (rng.random((n, 64)) < 0.3)
    zz[:, 0] = rng.integers(-2047, 2048, n)
    edges = []
    for run in (15, 16, 17, 32, 47, 48):
        row = np.zeros(64, np.int64)
        row[1] = 3
        row[2 + run] = -5
        edges.append(row)
    tail = np.zeros(64, np.int64)
    tail[63] = 7
    edges.append(tail)
    tail16 = np.zeros(64, np.int64)
    tail16[2] = 1
    edges.append(tail16)  # 61 zeros to the end: EOB, no ZRL
    full = rng.integers(1, 1024, 64) * rng.choice([-1, 1], 64)
    edges.append(full)
    edges.append(np.zeros(64, np.int64))
    for i, row in enumerate(edges):
        zz[(7 * i) % n, 1:] = row[1:]
    nat = np.zeros_like(zz)
    nat[:, ZIGZAG] = zz
    return nat.astype(np.int16)


def shim_symbols(y, cb, cr, sampling, n_groups, prev_dc=None):
    y, cb, cr = (np.ascontiguousarray(a) for a in (y, cb, cr))
    n = cb.shape[0]
    b = n * (6 if sampling == "420" else 3)
    codes = np.zeros((b, 65), np.int32)
    lens = np.zeros((b, 65), np.int32)
    luts = np.ascontiguousarray(LUTS["packed"].numpy())
    pd = None if prev_dc is None else np.ascontiguousarray(prev_dc, np.int32)
    load_host_shim().symbol_streams_host(_ptr(y), _ptr(cb), _ptr(cr), n,
                                         int(sampling == "420"), n_groups,
                                         None if pd is None else _ptr(pd), _ptr(luts),
                                         _ptr(codes), _ptr(lens))
    return codes, lens


@pytest.mark.parametrize("sampling", ["444", "420"])
@pytest.mark.parametrize("n_groups,carried", [(1, False), (4, False), (12, False), (1, True)])
def test_symbol_bodies_match_plain(sampling, n_groups, carried):
    """Restart groups of 1, 3 and 12 MCUs (the DC chain resets at each) and
    the carried form from a nonzero prev_dc."""
    rng = np.random.default_rng(n_groups)
    n = 24
    luma = 4 if sampling == "420" else 1
    y, cb, cr = (edge_blocks(rng, cnt) for cnt in (luma * n, n, n))
    prev_dc = np.array([300, -41, 77], np.int32) if carried else None
    got_c, got_l = shim_symbols(y, cb, cr, sampling, n_groups, prev_dc)
    want_c, want_l = K.symbol_streams(
        *(torch.from_numpy(a) for a in (y, cb, cr)), LUTS, n_groups, sampling,
        None if prev_dc is None else torch.from_numpy(prev_dc))
    np.testing.assert_array_equal(got_l, want_l.numpy())
    np.testing.assert_array_equal(got_c, want_c.numpy())
    # The edges are there: ZRL slots, EOB dropped after a nonzero at 63.
    zrl_len = int(LUTS["zrl_len"][0])
    assert (got_l[:, 1:64] == zrl_len).any() and (got_l[:, 64] == 0).any()


def test_symbol_streams_match_the_encoder_stages():
    """The wrapper's plain path is the encoder's: _symbol_streams_flat and
    _symbol_streams give its slots (and the carried DC)."""
    rng = np.random.default_rng(9)
    y, cb, cr = (torch.from_numpy(edge_blocks(rng, 12)) for _ in range(3))
    codes, lens = E._symbol_streams_flat(y, cb, cr, LUTS, 3)
    want = E.symbol_streams_plain(y, cb, cr, LUTS, 3)
    assert torch.equal(codes, want[0]) and torch.equal(lens, want[1])
    prev = torch.tensor([5, -6, 7], dtype=torch.int32)
    codes, lens, new_dc = E._symbol_streams(y, cb, cr, LUTS, prev)
    want = E.symbol_streams_plain(y, cb, cr, LUTS, 1, prev_dc=prev)
    assert torch.equal(codes, want[0]) and torch.equal(lens, want[1])
    assert new_dc.tolist() == [int(y[-1, 0]), int(cb[-1, 0]), int(cr[-1, 0])]


def test_packed_luts_follow_the_kernel_layout():
    packed = LUTS["packed"]
    assert packed.shape == (K.SYMBOL_LUT_WORDS,) and packed.dtype == torch.int32
    offsets = {"dc_code": 0, "dc_len": 32, "ac_code": 64, "ac_len": 576, "zrl_code": 1088,
               "zrl_len": 1090, "eob_code": 1092, "eob_len": 1094}
    for name, off in offsets.items():
        t = LUTS[name].reshape(-1)
        assert torch.equal(packed[off : off + t.numel()], t)


# --------------------------------------------------------------------------- #
# Wrappers: checks and launch counts
# --------------------------------------------------------------------------- #


def test_wrappers_check_inputs_and_count_only_launches():
    zz = torch.zeros((14, 8), dtype=torch.int16)
    q = torch.ones(64, dtype=torch.int32)
    band = torch.zeros((16, 16, 4), dtype=torch.uint8)
    counts = [w.launches for w in (K.idct_dequant, K.ycc_rgba, K.fdct_quant, K.symbol_streams)]
    plane = K.idct_dequant(zz, q, 7)
    assert plane.shape == (16, 56) and bool((plane == 128).all())
    out = torch.zeros((8, 60, 4), dtype=torch.uint8)
    K.ycc_rgba([plane], [(1, 1, 0, 0, 8, 56)], out, 2, 56)
    blocks = K.fdct_quant(band, q, q, "420")
    K.symbol_streams(*blocks, LUTS, 1, "420")
    assert counts == [w.launches for w in (K.idct_dequant, K.ycc_rgba, K.fdct_quant,
                                           K.symbol_streams)]
    with pytest.raises(TypeError):
        K.idct_dequant(zz.to(torch.int32), q, 7)
    with pytest.raises(ValueError):
        K.idct_dequant(zz, q, 5)  # 14 blocks are not rows of 5
    with pytest.raises(ValueError):
        K.ycc_rgba([plane], [(1, 1, 0, 0, 8, 56)], out, 5, 56)  # past the band
    with pytest.raises(ValueError):
        K.ycc_rgba([plane], [(1, 1, 1, 0, 8, 56)], out, 0, 56)  # window too short
    with pytest.raises(ValueError):
        K.ycc_rgba([plane, plane], [(1, 1, 0, 0, 8, 56)] * 2, out, 0, 56)
    with pytest.raises(ValueError):
        K.fdct_quant(band[:8], q, q, "420")
    with pytest.raises(TypeError):
        K.fdct_quant(band[..., :2].contiguous(), q, q)
    with pytest.raises(ValueError):
        K.symbol_streams(*blocks, LUTS, 3, "420")  # 1 MCU, 3 groups
    with pytest.raises(ValueError):
        K.symbol_streams(*blocks, LUTS, 1, "444")
    with pytest.raises(ValueError):
        K.symbol_streams(*blocks, LUTS, 1, "420", prev_dc=torch.zeros(2, dtype=torch.int32))
