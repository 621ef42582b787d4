"""The JPEG kernels' own arithmetic against their plain torch versions.

csrc/idct.cuh, ycc.cuh, fdct_quant.cuh, symbols.cuh and layout.cuh, compiled by g++
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
from image_stitch_tpu_torch.testing import Tile, make_band, mixed_band
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
# The batched decode: every window and tile of a band through one table
# --------------------------------------------------------------------------- #


def shim_idct_batch(band, jobs) -> np.ndarray:
    """The shim over the CTA table that the card's kernel reads."""
    planes = np.zeros(band.plane_bytes, np.uint8)
    ctas = K.idct_cta_table(jobs).numpy()
    load_host_shim().idct_dequant_batch_host(_ptr(band.coefs), _ptr(band.qtabs), _ptr(ctas),
                                             len(ctas), _ptr(planes))
    return planes


def shim_ycc_batch(planes: np.ndarray, tiles, out: np.ndarray) -> np.ndarray:
    tiles = tiles.numpy()
    load_host_shim().ycc_rgba_batch_host(_ptr(planes), _ptr(tiles), len(tiles),
                                         int(tiles[:, 2].max()), _ptr(out), out.shape[1] * 4,
                                         out.shape[0])
    return out


def batch_tables(band, address: int = 0):
    return K.idct_job_table(band.windows), K.ycc_tile_table(band.tiles, band.width, address)


def loop_of_singles(band, fill: int) -> np.ndarray:
    """The band through the single-window wrappers, tile by tile."""
    out = torch.full((band.h, band.width, 4), fill, dtype=torch.uint8)
    for x0, width, comps in band.singles:
        planes = [K.idct_dequant(torch.from_numpy(zz), torch.from_numpy(q), bx)
                  for zz, q, bx, _geom in comps]
        K.ycc_rgba(planes, [geom for _zz, _q, _bx, geom in comps], out, x0, width)
    return out.numpy()


@pytest.mark.parametrize("width_off_4", [False, True])
@pytest.mark.parametrize("seed", [1, 2])
def test_batched_bodies_match_plain_and_single_windows(seed, width_off_4):
    """A mixed table (K 8, 24, 64; 4:4:4, h2v1, h2v2, gray, 4:1:1, 4:4:0;
    comp_w 2 and 3; top and bottom image edges; x0 % 4 of 0..3; widths off
    4; coefficients at the int16 extremes under 16-bit quantizers beside
    small ones): the shim's batched bodies, the batched plain versions and a
    loop of the single-window calls give the same planes and the same band;
    what lies between the tiles is not touched. Tolerance: none."""
    band = mixed_band(seed, width_off_4)
    jobs, tiles = batch_tables(band)
    flags = jobs[:, 6].tolist()
    assert 0 in flags and K.IDCT_JOB_INT32 in flags  # both column passes run
    variants = tiles[:, 3].tolist()
    assert set(variants) == ({0} if width_off_4 else {0, 1})

    planes = shim_idct_batch(band, jobs)
    want_planes = K.idct_dequant_batch(
        torch.from_numpy(band.coefs), torch.from_numpy(band.qtabs), jobs,
        torch.zeros(band.plane_bytes, dtype=torch.uint8))
    np.testing.assert_array_equal(planes, want_planes.numpy())

    out = shim_ycc_batch(planes, tiles, np.full((band.h, band.width, 4), 7, np.uint8))
    want = K.ycc_rgba_batch(want_planes, tiles,
                            torch.full((band.h, band.width, 4), 7, dtype=torch.uint8))
    np.testing.assert_array_equal(out, want.numpy())
    np.testing.assert_array_equal(out, loop_of_singles(band, 7))
    covered = np.zeros(band.width, bool)
    for x0, width, _comps in band.tiles:
        covered[x0 : x0 + width] = True
    assert (out[:, ~covered] == 7).all() and (out[:, covered, 3] == 255).all()


def test_batched_bodies_on_a_table_of_one_job():
    """One gray tile: one job, one tile, against the single-window shim
    bodies (the int64 IDCT and the pixel-at-a-time colour)."""
    rng = np.random.default_rng(3)
    band = make_band(rng, [Tile("444", 19, 16, 0, 16, ks=(40,), gray=True)], [1], 21)
    jobs, tiles = batch_tables(band)
    assert jobs.shape == (1, K.IDCT_JOB_COLS) and tiles.shape == (1, K.YCC_TILE_COLS)
    planes = shim_idct_batch(band, jobs)
    zz, q, bx, geom = band.singles[0][2][0]
    single = shim_idct(zz, q, bx)
    np.testing.assert_array_equal(planes.reshape(single.shape), single)
    out = shim_ycc_batch(planes, tiles, np.zeros((16, 21, 4), np.uint8))
    np.testing.assert_array_equal(out, shim_ycc([single], [geom], np.zeros((16, 21, 4), np.uint8),
                                                1, 19))


@pytest.mark.parametrize("narrow", [True, False])
def test_both_column_passes_at_the_edge_of_the_32_bit_bound(narrow):
    """|coefficient * quantizer| = IDCT_INT32_MAX_DEQ in every position, all
    of one sign and with alternating signs (the largest sums the pass can
    make): the 32-bit column pass, which the flag allows up to here, and the
    64-bit one give the plain version's samples; one past the bound only the
    64-bit pass is asked."""
    rng = np.random.default_rng(4)
    m = K.IDCT_INT32_MAX_DEQ
    bx = 8
    zz = np.full((2 * bx, 64), m if narrow else m + 1, np.int64)
    zz[1] *= -1
    zz[2, ::2] *= -1
    zz[3] *= np.where(rng.random(64) < 0.5, -1, 1)
    for b in range(4, 2 * bx):  # the sign pattern of each row of the pass's matrix
        zz[b] *= np.where(rng.random(64) < 0.5, -1, 1)
    zz[:, 0] = np.clip(zz[:, 0], -(1 << 15), (1 << 15) - 1)
    zz = np.clip(zz, -(1 << 15), (1 << 15) - 1).astype(np.int16)
    q = np.ones(64, np.int32)
    want = D.decode_plane(torch.from_numpy(zz), torch.from_numpy(q), bx).numpy()
    for flag in ([1, 0] if narrow else [0]):
        ctas = K.idct_cta_table(K.idct_job_table([(0, 2 * bx, 64, 0, bx, 0, flag)])).numpy()
        planes = np.zeros(2 * bx * 64, np.uint8)
        load_host_shim().idct_dequant_batch_host(_ptr(zz), _ptr(q), _ptr(ctas), len(ctas),
                                                 _ptr(planes))
        np.testing.assert_array_equal(planes.reshape(want.shape), want)


def test_a_job_past_the_bound_must_have_its_flag_cleared():
    """Full-range coefficients under a quantizer of 255, far past the bound:
    the 32-bit column pass overflows and gives other samples, which is why
    the flag is the host's to clear. The single-window wrapper clears it by
    itself; the batched wrapper's CPU path refuses a set flag on such a job
    and takes a cleared one."""
    rng = np.random.default_rng(6)
    bx = 4
    zz = rng.integers(-(1 << 15), 1 << 15, (2 * bx, 64)).astype(np.int16)
    q = np.full(64, 255, np.int32)
    want = D.decode_plane(torch.from_numpy(zz), torch.from_numpy(q), bx).numpy()
    got = {}
    for flag in (0, 1):
        ctas = K.idct_cta_table(K.idct_job_table([(0, 2 * bx, 64, 0, bx, 0, flag)])).numpy()
        got[flag] = np.zeros(2 * bx * 64, np.uint8)
        load_host_shim().idct_dequant_batch_host(_ptr(zz), _ptr(q), _ptr(ctas), len(ctas),
                                                 _ptr(got[flag]))
    np.testing.assert_array_equal(got[0].reshape(want.shape), want)
    assert (got[1].reshape(want.shape) != want).any()
    np.testing.assert_array_equal(
        K.idct_dequant(torch.from_numpy(zz), torch.from_numpy(q), bx).numpy(), want)
    coefs, qtabs = torch.from_numpy(zz).reshape(-1), torch.from_numpy(q).view(1, 64)
    with pytest.raises(ValueError):
        K.idct_dequant_batch(coefs, qtabs, K.idct_job_table([(0, 2 * bx, 64, 0, bx, 0, 1)]),
                             torch.zeros(2 * bx * 64, dtype=torch.uint8))
    planes = K.idct_dequant_batch(coefs, qtabs, K.idct_job_table([(0, 2 * bx, 64, 0, bx, 0, 0)]),
                                  torch.zeros(2 * bx * 64, dtype=torch.uint8))
    np.testing.assert_array_equal(planes.numpy().reshape(want.shape), want)


@pytest.mark.parametrize("which", ["idct", "ycc"])
def test_a_staged_table_goes_only_with_the_table_it_was_made_from(which):
    """What the kernel reads is made from the table the wrapper checks, by
    ``StagedTable``, which also places it in the upload: a wrapper given a
    staged table with another host table (an equal copy even) raises; so
    does staging off a 16 B boundary, binding before staging or to bytes
    that end too early, and launching before the upload."""
    band = mixed_band(7)
    jobs, tiles = batch_tables(band)
    coefs, qtabs = torch.from_numpy(band.coefs), torch.from_numpy(band.qtabs)
    planes = torch.zeros(band.plane_bytes, dtype=torch.uint8)
    out = torch.zeros((band.h, band.width, 4), dtype=torch.uint8)
    if which == "idct":
        source, staged = jobs, K.StagedTable.for_idct(jobs)
        assert torch.equal(staged.rows, K.idct_cta_table(jobs))

        def call(table, st):
            return K.idct_dequant_batch(coefs, qtabs, table, planes, staged=st)
    else:
        source, staged = tiles, K.StagedTable.for_ycc(tiles)
        assert staged.rows is tiles

        def call(table, st):
            return K.ycc_rgba_batch(planes, table, out, staged=st)
    assert staged.source is source
    with pytest.raises(ValueError):
        call(source.clone(), staged)
    buf = np.zeros(32 + staged.nbytes, np.uint8)
    with pytest.raises(ValueError):
        staged.bind(torch.from_numpy(buf))  # not staged yet
    with pytest.raises(ValueError):
        staged.stage(buf, 8)
    with pytest.raises(ValueError):
        K._staged_rows(staged, torch.device("cpu"))  # not uploaded yet
    staged.stage(buf, 32)
    with pytest.raises(ValueError):
        staged.bind(torch.from_numpy(buf[:-4]))
    with pytest.raises(TypeError):
        staged.bind(torch.from_numpy(buf.view(np.int32)))
    staged.bind(torch.from_numpy(buf))
    assert torch.equal(K._staged_rows(staged, torch.device("cpu")), staged.rows)
    assert staged.device.data_ptr() == torch.from_numpy(buf).data_ptr() + 32
    call(source, staged)  # the CPU path takes it with its own table


def test_the_pass_matrix_gives_the_32_bit_bound():
    """IDCT_PASS_L1 is the largest sum of |a_i| over the pass's outputs, and
    IDCT_INT32_MAX_DEQ keeps IDCT_PASS_L1 * M + 2^10 below 2^31."""
    shim = load_host_shim()
    cols = []
    for i in range(8):
        v = np.zeros(8, np.int64)
        v[i] = 2
        shim.idct_pass_host(_ptr(v), 1)  # (2 a + 1) >> 1 = a
        cols.append(v.copy())
    l1 = np.abs(np.stack(cols, axis=1)).sum(axis=1)
    assert int(l1.max()) == 61214
    assert 61214 * K.IDCT_INT32_MAX_DEQ + 1024 < 1 << 31


def test_both_range_limits_over_the_cycle():
    """The 32-bit range limit (10-bit two's complement plus 128, clamped)
    equals POST[x & 1023] for every residue, at any height."""
    x = np.concatenate([np.arange(-4096, 4096), np.arange(-2048, 2048) * (1 << 18) + 517,
                        [-(1 << 31), (1 << 31) - 1]]).astype(np.int64)
    u = (x & 0xFFFFFFFF).astype(np.uint32)
    narrow, wide = np.zeros(len(u), np.uint8), np.zeros(len(u), np.uint8)
    load_host_shim().idct_range_limit_host(_ptr(u), _ptr(narrow), _ptr(wide), len(u))
    want = D.range_limit(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(narrow, want)
    np.testing.assert_array_equal(wide, want)


def test_batched_wrappers_check_their_tables():
    band = mixed_band(5)
    jobs, tiles = batch_tables(band)
    coefs, qtabs = torch.from_numpy(band.coefs), torch.from_numpy(band.qtabs)
    planes = torch.zeros(band.plane_bytes, dtype=torch.uint8)
    out = torch.zeros((band.h, band.width, 4), dtype=torch.uint8)

    def bad(col, value, row=1):
        t = jobs.clone()
        t[row, col] = value
        return t

    for table in (bad(0, 4), bad(0, len(coefs)), bad(2, 12), bad(2, 72), bad(3, len(qtabs)),
                  bad(4, 5), bad(5, 8), bad(5, band.plane_bytes), bad(1, 0), jobs[:, :7],
                  jobs.to(torch.int64)):
        with pytest.raises((ValueError, TypeError)):
            K.idct_dequant_batch(coefs, qtabs, table, planes)
    with pytest.raises(TypeError):
        K.idct_dequant_batch(coefs.to(torch.int32), qtabs, jobs, planes)
    with pytest.raises(ValueError):
        K.idct_dequant_batch(coefs, qtabs[:, :32], jobs, planes)

    def bad_tile(col, value, row=0):
        t = tiles.clone()
        t[row, col] = value
        return t

    comp = K.YCC_TILE_COMP
    for table in (bad_tile(0, 2), bad_tile(1, -1), bad_tile(2, band.width + 1), bad_tile(3, 2),
                  bad_tile(3, 1, row=1), bad_tile(comp, band.plane_bytes),
                  bad_tile(comp + 1, 1), bad_tile(comp + 6, 2), bad_tile(comp + 8 + 7, 1)):
        with pytest.raises(ValueError):
            K.ycc_rgba_batch(planes, table, out)
    with pytest.raises(ValueError):
        K.ycc_rgba_batch(planes, tiles, out[:, :, :3].contiguous())
    counts = K.idct_dequant.launches, K.ycc_rgba.launches
    K.idct_dequant_batch(coefs, qtabs, jobs, planes)
    K.ycc_rgba_batch(planes, tiles, out)
    assert counts == (K.idct_dequant.launches, K.ycc_rgba.launches)  # the CPU never launches


def test_variants_and_tables():
    assert K.YCC_VARIANTS[K.ycc_variant(8, 64, 4096)] == "vec16"
    for x0, width, address in ((9, 64, 4096), (8, 66, 4096), (8, 64, 4100)):
        assert K.YCC_VARIANTS[K.ycc_variant(x0, width, address)] == "words"
    jobs = K.idct_job_table([(0, 18, 8, 0, 3, 0, 1), (144, 40, 16, 1, 20, 1152, 0)])
    assert jobs[:, 6].tolist() == [K.IDCT_JOB_INT32, 0]
    # 18 blocks in rows of 3: CTAs of 16 and 2 blocks, the second at block row
    # 5, place 1; 40 blocks in rows of 20: 16 + 16 + 8, the third at row 1,
    # place 12.
    assert K.IDCT_CTA_BLOCKS == 16
    assert K.idct_cta_table(jobs).tolist() == [
        [0, 16, 8, 0, 3, 0, 0, 1], [128, 2, 8, 0, 3, 5 * 64 * 3, 1, 1],
        [144, 16, 16, 1, 20, 1152, 0, 0], [144 + 256, 16, 16, 1, 20, 1152, 16, 0],
        [144 + 512, 8, 16, 1, 20, 1152 + 64 * 20, 12, 0]]
    comps = [(0, 8, 1, 1, 0, 0, 8, 5)]
    tiles = K.ycc_tile_table([(0, 5, comps), (8, 300, comps)], 400, 0)
    assert tiles[:, :4].tolist() == [[1, 0, 5, 1], [1, 8, 300, 1]]
    assert tiles[0, K.YCC_TILE_COMP : K.YCC_TILE_COMP + 8].tolist() == list(comps[0])


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
    # The kernel's quantizer, by reciprocal, at the same edges.
    recip = np.zeros(c.shape, np.int16)
    load_host_shim().fdct_quantize_recip_host(_ptr(c), _ptr(q), _ptr(recip), c.size)
    np.testing.assert_array_equal(recip, want)


def shim_quantize(c: np.ndarray, q: np.ndarray):
    """(exact division, reciprocal) quantizers of the shim on (c, q) pairs."""
    c, q = np.ascontiguousarray(c, np.int32), np.ascontiguousarray(q, np.int32)
    exact, recip = np.zeros(c.shape, np.int16), np.zeros(c.shape, np.int16)
    load_host_shim().fdct_quantize_host(_ptr(c), _ptr(q), _ptr(exact), c.size)
    load_host_shim().fdct_quantize_recip_host(_ptr(c), _ptr(q), _ptr(recip), c.size)
    return exact, recip


@pytest.mark.parametrize("sign", [1, -1])
def test_reciprocal_quantizer_at_every_multiple_of_every_q(sign):
    """|c| + 4q one below, at and one above every multiple of 8q that the
    FDCT can reach (|c| < 2^15, its outputs stay below 2^14) for every q of
    1..255: the reciprocal's one-sided correction against the division."""
    qs, cs = [], []
    for q in range(1, 256):
        mult = np.arange(1, (1 << 15) // (8 * q) + 2, dtype=np.int64) * 8 * q
        mag = (mult[:, None] + np.array([-1, 0, 1])[None, :] - 4 * q).reshape(-1)
        mag = mag[(mag >= 0) & (mag < 1 << 15)]
        cs.append(sign * mag)
        qs.append(np.full(mag.shape, q))
    c, q = np.concatenate(cs).astype(np.int32), np.concatenate(qs).astype(np.int32)
    exact, recip = shim_quantize(c, q)
    np.testing.assert_array_equal(recip, exact)
    want = quantize_islow(torch.from_numpy(c), torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(recip, want)


def test_reciprocal_quantizer_exhaustive_for_the_quality_tables():
    """Every coefficient of -2^15 .. 2^15 against every quantizer that
    quality_scaled_tables emits at q 1, 10, 50, 85 and 100, and the 16-bit
    table's ends."""
    qvals = sorted({int(v) for quality in (1, 10, 50, 85, 100)
                    for t in quality_scaled_tables(quality) for v in t.reshape(-1)}
                   | {1, 2, 3, 255, 256, 4095, 65535})
    assert min(qvals) >= 1
    c = np.arange(-(1 << 15), (1 << 15) + 1, dtype=np.int32)
    for qv in qvals:
        exact, recip = shim_quantize(c, np.full(c.shape, qv, np.int32))
        np.testing.assert_array_equal(recip, exact, err_msg=f"q={qv}")


@pytest.mark.parametrize("sampling", ["444", "420"])
@pytest.mark.parametrize("channels", [3, 4, 5])
@pytest.mark.parametrize("width", [16, 32, 48, 272, 400])
def test_fdct_split_matches_plain_at_ragged_widths(sampling, channels, width):
    """The row and column tasks of the shim (8 per block, as the card's
    threads) against band_to_blocks_islow[_420]: widths of one block or MCU,
    off the kernel's 128-pixel tile (272 = 2 tiles and 16 pixels, 400), a
    pixel stride of 3, 4 and 5 bytes; random bytes with pure blue, 0 and 255
    areas."""
    rng = np.random.default_rng(width + channels)
    h = 32
    band = rng.integers(0, 256, (h, width, channels), dtype=np.uint8)
    band[:8, :, :3] = (0, 0, 255)  # Cb = 256
    band[8:12] = 0
    band[12:16] = 255
    lq, cq = (t.astype(np.int32) for t in quality_scaled_tables(85))
    got = shim_fdct(band, lq, cq, sampling)
    want = K.fdct_quant(torch.from_numpy(band), torch.from_numpy(lq), torch.from_numpy(cq),
                        sampling)
    for g, t in zip(got, want):
        np.testing.assert_array_equal(g, t.numpy())


def test_fdct_variant_follows_stride_and_alignment():
    assert K.FDCT_VARIANTS == ("bytes", "rgb_vec8", "rgba_vec16")
    assert K.fdct_variant(4, 4096) == 2 and K.fdct_variant(4, 4100) == 0
    assert K.fdct_variant(3, 4096) == 1 and K.fdct_variant(3, 4104) == 1
    assert K.fdct_variant(3, 4100) == 0 and K.fdct_variant(5, 4096) == 0


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
    bits = np.zeros(b, np.int32)
    last_dc = np.zeros(3, np.int32)
    load_host_shim().symbol_streams_host(_ptr(y), _ptr(cb), _ptr(cr), n,
                                         int(sampling == "420"), n_groups,
                                         None if pd is None else _ptr(pd), _ptr(luts),
                                         _ptr(codes), _ptr(lens), _ptr(bits), _ptr(last_dc))
    return codes, lens, bits, last_dc


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
    got_c, got_l, got_bits, got_dc = shim_symbols(y, cb, cr, sampling, n_groups, prev_dc)
    want_c, want_l, want_bits, want_dc = K.symbol_streams(
        *(torch.from_numpy(a) for a in (y, cb, cr)), LUTS, n_groups, sampling,
        None if prev_dc is None else torch.from_numpy(prev_dc))
    np.testing.assert_array_equal(got_l, want_l.numpy())
    np.testing.assert_array_equal(got_c, want_c.numpy())
    np.testing.assert_array_equal(got_bits, got_l.sum(axis=1))
    np.testing.assert_array_equal(got_bits, want_bits.numpy())
    np.testing.assert_array_equal(got_dc, want_dc.numpy())
    assert got_dc.tolist() == [int(a[-1, 0]) for a in (y, cb, cr)]
    # The edges are there: ZRL slots, EOB dropped after a nonzero at 63.
    zrl_len = int(LUTS["zrl_len"][0])
    assert (got_l[:, 1:64] == zrl_len).any() and (got_l[:, 64] == 0).any()


def zigzag_blocks(rows) -> np.ndarray:
    """Blocks given in zigzag order -> (n, 64) int16 natural order."""
    zz = np.asarray(rows, np.int64).reshape(-1, 64)
    nat = np.zeros_like(zz)
    nat[:, ZIGZAG] = zz
    return nat.astype(np.int16)


def run_block(gap: int, first: int = 1, end63: bool = False) -> np.ndarray:
    """A nonzero at zigzag position ``first``, ``gap`` zeros, a nonzero;
    with ``end63`` another at position 63."""
    row = np.zeros(64, np.int64)
    row[first] = 2
    if first + gap + 1 < 64:
        row[first + gap + 1] = -3
    if end63:
        row[63] = 1
    return row


SLOT_EDGES = {
    "all_zero": np.zeros(64, np.int64),
    "dc_only": np.r_[-1024, np.zeros(63, np.int64)],
    "63_nonzeros": np.r_[5, np.arange(1, 64) * np.where(np.arange(63) % 2, -1, 1)],
    "run15": run_block(15), "run16": run_block(16), "run17": run_block(17),
    "run32": run_block(32), "run48": run_block(48),
    "run15_to_63": run_block(15, first=47), "run16_to_63": run_block(16, first=46),
    "run48_then_63": run_block(48, end63=True),
    "only_63": np.r_[np.zeros(63, np.int64), 9],
    "only_16": np.r_[np.zeros(16, np.int64), 1, np.zeros(47, np.int64)],
    "only_17_and_33": run_block(15, first=17),
    "zeros_after_2": np.r_[0, 0, 1, np.zeros(61, np.int64)],
    "int16_extremes": np.r_[32767, -32767, 32767, np.zeros(59, np.int64), -32767, 32767],
    "word_boundary_31_32": np.r_[np.zeros(31, np.int64), 4, -4, np.zeros(31, np.int64)],
    "word_boundary_32_only": np.r_[np.zeros(32, np.int64), 1, np.zeros(31, np.int64)],
}


@pytest.mark.parametrize("name", sorted(SLOT_EDGES))
@pytest.mark.parametrize("sampling", ["444", "420"])
def test_symbol_slot_edges_match_plain(name, sampling):
    """Each edge of the mask arithmetic in every block of two MCUs, beside
    a full block, so that luma and chroma tables and every DC predecessor
    meet it: zero runs of 15, 16, 17, 32 and 48, runs that end at position
    63, a lone nonzero at 16, 32 or 63, the ballots' word boundary (31 | 32),
    and coefficients of +-32767, the largest the tables index (size
    category 15; -32768 would be 16)."""
    luma = 4 if sampling == "420" else 1
    edge, full = SLOT_EDGES[name], SLOT_EDGES["63_nonzeros"]
    y = zigzag_blocks([edge, full] * luma)
    cb = zigzag_blocks([edge, full])
    cr = zigzag_blocks([full, edge])
    got = shim_symbols(y, cb, cr, sampling, 1)
    want = K.symbol_streams(*(torch.from_numpy(a) for a in (y, cb, cr)), LUTS, 1, sampling)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    np.testing.assert_array_equal(got[2], got[1].sum(axis=1))


def test_divisibility_test_matches_modulo():
    """The kernel's "first block of a restart group" test, n % d == 0 by a
    multiply and a compare, for every n up to 70,000 against small and
    awkward d, and random 32-bit pairs with multiples among them."""
    rng = np.random.default_rng(0)
    ds = np.array([1, 2, 3, 5, 7, 64, 1000, 1024, 4095, 32768, 65537, 2**31 - 1, 2**32 - 1],
                  np.uint64)
    n = np.concatenate([np.tile(np.arange(70000, dtype=np.uint64), len(ds)),
                        rng.integers(0, 2**32, 200000, dtype=np.uint64)])
    d = np.concatenate([np.repeat(ds, 70000), rng.integers(1, 2**32, 200000, dtype=np.uint64)])
    mult = rng.integers(1, 2**16, 50000, dtype=np.uint64)
    d2 = rng.integers(1, 2**16, 50000, dtype=np.uint64)
    n, d = np.concatenate([n, mult * d2]), np.concatenate([d, d2])
    n32, d32 = np.ascontiguousarray(n, np.uint32), np.ascontiguousarray(d, np.uint32)
    got = np.zeros(n.shape, np.uint8)
    load_host_shim().sym_divides_host(_ptr(n32), _ptr(d32), _ptr(got), n.size)
    np.testing.assert_array_equal(got.astype(bool), n % d == 0)


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
# group_layout
# --------------------------------------------------------------------------- #


def shim_layout(block_bits: np.ndarray, n_groups: int, bit_base=None):
    """(starts, group_bits, max_bits, total_bits, next_base) of the shim,
    which cuts the band into the card's chunks."""
    bits = np.ascontiguousarray(block_bits, np.int32)
    starts = np.full(bits.shape, -1, np.int32)
    group_bits = np.full(n_groups, -1, np.int32)
    max_bits = np.full(1, -1, np.int32)
    totals = np.full(2, -1, np.int64)
    base = None if bit_base is None else np.array([bit_base], np.int64)
    load_host_shim().group_layout_host(
        _ptr(bits), bits.size, n_groups, None if base is None else _ptr(base), _ptr(starts),
        _ptr(group_bits), _ptr(max_bits), None if base is None else _ptr(totals))
    if base is None:
        return starts, group_bits, int(max_bits[0]), None, None
    return starts, group_bits, int(max_bits[0]), int(totals[0]), int(totals[1])


def check_layout(block_bits: np.ndarray, n_groups: int, bit_base=None):
    """The shim and the wrapper's CPU branch against the encoder's torch
    code: ``_group_layout`` over lengths with these sums, or the carried
    stream's int64 cumulative sum."""
    bits_t = torch.from_numpy(np.ascontiguousarray(block_bits, np.int32))
    base_t = None if bit_base is None else torch.tensor(bit_base, dtype=torch.int64)
    got = shim_layout(block_bits, n_groups, bit_base)
    plain = K.group_layout(bits_t, n_groups, base_t)
    if bit_base is None:
        lens = torch.zeros((bits_t.shape[0], 65), dtype=torch.int32)
        lens[:, 0] = bits_t // 2
        lens[:, 64] = bits_t - bits_t // 2
        want_starts, want_groups, want_bits = E._group_layout(lens, n_groups)
        assert torch.equal(want_bits, bits_t)
        assert got[3] is None and got[4] is None and plain[3] is None and plain[4] is None
    else:
        b64 = bits_t.to(torch.int64)
        want_starts = (base_t + torch.cumsum(b64, 0) - b64).to(torch.int32)
        total = int(base_t + b64.sum())
        want_groups = bits_t.sum(dim=0, keepdim=True, dtype=torch.int32)
        assert got[3] == int(plain[3]) == total
        assert got[4] == int(plain[4]) == total % 8
    np.testing.assert_array_equal(got[0], want_starts.numpy())
    np.testing.assert_array_equal(got[1], want_groups.numpy())
    assert got[2] == int(bits_t.max()) == int(plain[2])
    assert torch.equal(plain[0], want_starts) and torch.equal(plain[1], want_groups)
    assert plain[0].dtype == plain[1].dtype == plain[2].dtype == torch.int32


def typical_bits(rng, n: int) -> np.ndarray:
    """Block bit counts as the encoder sees them: 4 bits (an all-zero block)
    to a few hundred, one block in 50 over the 768-bit budget."""
    bits = rng.integers(4, 400, n)
    bits[rng.random(n) < 0.02] = rng.integers(769, 1700, 1)
    return bits.astype(np.int32)


# (blocks per group, groups): group lengths that are no multiple of 32 or of
# the 1024-block chunk, one short group (the tail dispatch), 4:2:0 groups of
# 6 blocks per MCU, groups of exactly one and two chunks and one block more,
# and a full-width 4:4:4 band as 1, 4, 12 and 32 groups.
LAYOUT_GROUPS = [(3, 1), (3, 7), (18, 4), (45, 12), (6 * 7, 32), (1023, 3), (1024, 2),
                 (1025, 2), (2048, 1), (2049, 3), (3072, 32), (8192, 12), (24576, 4),
                 (98304, 1), (100, 333), (1, 1), (1, 2000)]


@pytest.mark.parametrize("group_len,n_groups", LAYOUT_GROUPS)
def test_layout_chunks_match_plain_for_groups(group_len, n_groups):
    rng = np.random.default_rng(group_len + n_groups)
    check_layout(typical_bits(rng, group_len * n_groups), n_groups)


@pytest.mark.parametrize("n_blocks", [3, 1024, 1030, 5000, 98304])
@pytest.mark.parametrize("bit_base", [0, 1, 7])
def test_layout_chunks_match_plain_for_the_carried_stream(n_blocks, bit_base):
    rng = np.random.default_rng(n_blocks + bit_base)
    check_layout(typical_bits(rng, n_blocks), 1, bit_base)


@pytest.mark.parametrize("bit_base", range(8))
def test_layout_carries_every_bit_base(bit_base):
    check_layout(typical_bits(np.random.default_rng(bit_base), 2500), 1, bit_base)


def test_layout_groups_of_whole_words_and_one_bit_more():
    """Groups whose bits are an exact multiple of 32 take no word more; one
    bit more takes one."""
    bits = np.full(6 * 40, 16, np.int32)  # 6 groups of 640 bits = 20 words
    starts, group_bits, *_ = shim_layout(bits, 6)
    assert starts[40] == 640 and group_bits.tolist() == [640] * 6
    check_layout(bits, 6)
    bits[39] = 17
    starts, group_bits, *_ = shim_layout(bits, 6)
    assert starts[40] == 672 and group_bits[0] == 641
    check_layout(bits, 6)
    check_layout(np.zeros(12, np.int32), 4)  # empty groups take no word


def test_layout_counts_over_budget_blocks_in_full():
    """A block past the 768-bit budget moves its successors by all of its
    bits, though pack_merge clips its words."""
    bits = np.full(3000, 100, np.int32)
    bits[[0, 1023, 1024, 2999]] = [5000, 1700, 769, 900]
    starts, _, max_bits, *_ = shim_layout(bits, 1)
    assert starts[1] == 5000 and starts[1025] - starts[1024] == 769 and max_bits == 5000
    check_layout(bits, 1)
    check_layout(bits, 3)
    check_layout(bits, 1, 5)


def test_layout_sums_past_int32_wrap_as_torch_does():
    """2^31 bits and more in a band: the plain version's int32 casts wrap,
    and the total stays a 64-bit sum."""
    bits = np.full(4096, (1 << 20) + 3, np.int32)
    check_layout(bits, 1, 3)
    check_layout(bits, 2)


def test_layout_hypothesis_drawn_bits_and_groups():
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @settings(max_examples=60, deadline=None, derandomize=True)
    @given(st.data())
    def run(data):
        n_groups = data.draw(st.integers(1, 40))
        group_len = data.draw(st.one_of(st.integers(1, 64), st.integers(1000, 2100)))
        seed = data.draw(st.integers(0, 2**32 - 1))
        top = data.draw(st.sampled_from([1, 33, 700, 4000]))
        bits = np.random.default_rng(seed).integers(0, top + 1, n_groups * group_len)
        carried = n_groups == 1 and data.draw(st.booleans())
        check_layout(bits.astype(np.int32), n_groups,
                     data.draw(st.integers(0, 7)) if carried else None)

    run()


def test_layout_wrapper_checks_inputs_and_counts_only_launches():
    bits = torch.arange(12, dtype=torch.int32)
    before = K.group_layout.launches
    K.group_layout(bits, 4)
    K.group_layout(bits, 1, torch.tensor(3))
    assert K.group_layout.launches == before
    with pytest.raises(TypeError):
        K.group_layout(bits.to(torch.int64), 4)
    with pytest.raises(ValueError):
        K.group_layout(bits, 5)  # 12 blocks, 5 groups
    with pytest.raises(ValueError):
        K.group_layout(bits[:0], 1)
    with pytest.raises(ValueError):
        K.group_layout(bits, 4, torch.tensor(3))  # a bit base with restart groups
    with pytest.raises(TypeError):
        K.group_layout(bits, 1, torch.tensor(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        K.group_layout(bits, 1, torch.tensor([3]))


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
