"""The torch port on a CUDA device: the kernels against their plain
versions, and the slice against the host tier.

Marked ``cuda``: they need a GPU and nvcc, and skip without them. They
import no jax, so on a GPU machine without jax they run without the suite's
conftest: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

import zlib

import numpy as np
import pytest
import torch

import image_stitch_tpu
import image_stitch_tpu.types
import image_stitch_tpu_torch
from image_stitch_tpu_torch.codecs.png.writer import build_png
from image_stitch_tpu_torch.ops import kernels as K
from image_stitch_tpu_torch.types import PngHeader, PositionedImage

pytestmark = pytest.mark.cuda


def png_from_array(rgba: np.ndarray) -> bytes:
    h, w, _ = rgba.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgba.reshape(h, w * 4)], axis=1)
    return build_png(PngHeader(width=w, height=h, bit_depth=8, color_type=6),
                     zlib.compress(raw.tobytes()))


def host(opts):
    """The JAX package's numpy host tier on ``opts``, the port's
    PositionedImage inputs given as that package's class."""
    inputs = [image_stitch_tpu.types.PositionedImage(i.x, i.y, i.source, z_index=i.z_index)
              if isinstance(i, PositionedImage) else i for i in opts["inputs"]]
    return image_stitch_tpu.concat_to_buffer({**opts, "inputs": inputs, "backend": "numpy"})


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def streams(nb, n_sym, lw, seed, clamp=True):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 17, size=(nb, n_sym)).astype(np.int32)
    lens[rng.random(lens.shape) < 0.3] = 0
    if clamp:
        over = lens.sum(axis=1) > lw * 32
        lens[over] = np.minimum(lens[over], 4)
    codes = (rng.integers(0, 1 << 16, size=(nb, n_sym)) & ((1 << lens) - 1)).astype(np.int32)
    starts = (np.concatenate([[0], np.cumsum(lens.sum(axis=1))[:-1]])
              + int(rng.integers(1, 32))).astype(np.int32)
    return codes, lens, starts


@pytest.mark.parametrize("nb,n_sym,lw,clamp", [(10, 11, 13, True), (5000, 65, 12, True),
                                               (3001, 65, 24, True), (700, 65, 4, False)])
def test_kernels_match_plain(cuda, nb, n_sym, lw, clamp):
    """pack_merge against the plain pack then merge, at a word count that
    holds the stream and at one that drops its last three words; (700, 65,
    4) has blocks over budget whose clipped words overlap."""
    codes, lens, starts = (torch.from_numpy(a).to(cuda)
                           for a in streams(nb, n_sym, lw, nb, clamp))
    launches = K.pack_merge.launches
    n_words = int(starts[-1] + lens[-1].sum()) // 32 + 1
    for nw in (n_words, n_words - 3):
        dense = K.pack_merge(codes, lens, starts, lw, nw)
        torch.cuda.synchronize()
        assert torch.equal(dense, K.pack_merge_plain(codes, lens, starts, lw, nw))
    assert K.pack_merge.launches == launches + 2


@pytest.mark.parametrize("ri,sampling", [(0, "444"), (1, "444"), (2, "420")])
def test_slice_matches_host(cuda, ri, sampling):
    rng = np.random.default_rng(ri)
    tiles = [png_from_array(rng.integers(0, 256, (72, 100, 4), dtype=np.uint8))
             for _ in range(4)]
    opts = {"inputs": tiles, "layout": {"columns": 2}, "outputFormat": "jpeg",
            "jpegRestartIntervalRows": ri, "jpegSampling": sampling, "bandHeight": 48}
    counters = image_stitch_tpu_torch.EncodeCounters()
    got = image_stitch_tpu_torch.concat_to_buffer(opts, device=cuda, counters=counters)
    assert got == host(opts)
    assert counters.bands > 0


def filter_band(cuda, shape, dtype, seed, kind="random", offset=0):
    """A band of ``shape`` on the card whose first byte lies ``offset``
    bytes past a 256 B aligned allocation, and a non-zero carry row."""
    rng = np.random.default_rng(seed)
    top = np.iinfo(dtype).max
    band = rng.integers(0, top + 1, shape, dtype=dtype)
    if kind == "extremes":
        band = ((band & 1) * top).astype(dtype)
    raw = band.view(np.uint8).reshape(-1)
    store = torch.zeros(raw.size + offset, dtype=torch.uint8, device=cuda)
    store[offset:] = torch.from_numpy(raw).to(cuda)
    t = store[offset:].view(band.view(np.uint8).shape)
    if dtype == np.uint16:
        t = t.view(torch.uint16)
    n = band[0].nbytes
    prev = torch.from_numpy(rng.integers(1, 256, n, dtype=np.uint8)).to(cuda)
    return t, prev


# Shapes 3.. reach every kernel of csrc/filter.cu: rows with n % 16 of 4, 8
# and 12 (4 B loads, a partial last chunk), rows longer than the registers
# hold (re-read from L2), bpp 3, and rows that start 4 B past a 16 B line.
@pytest.mark.parametrize("shape,dtype,bpp", [((37, 11, 4), np.uint8, 4),
                                             ((256, 2048, 4), np.uint16, 8),
                                             ((9, 3), np.uint8, 4),
                                             ((256, 8192, 4), np.uint8, 4),
                                             ((37, 17, 4), np.uint8, 4),
                                             ((29, 19, 4), np.uint8, 4),
                                             ((16, 8197, 4), np.uint8, 4),
                                             ((16, 8200, 4), np.uint8, 4),
                                             ((13, 1025, 4), np.uint16, 8),
                                             ((8, 5000, 4), np.uint16, 8),
                                             ((11, 40, 3), np.uint8, 3),
                                             ((7, 6, 4), np.uint16, 4)])
def test_filter_select_matches_plain(cuda, shape, dtype, bpp):
    for kind in ("random", "extremes"):
        t, prev = filter_band(cuda, shape, dtype, shape[0], kind)
        launches = K.filter_select.launches
        types, filtered = K.filter_select(t, prev, bpp)
        p_types, p_filtered = K.filter_select_plain(t, prev, bpp)
        torch.cuda.synchronize()
        assert torch.equal(types, p_types) and torch.equal(filtered, p_filtered)
        assert K.filter_select.launches == launches + 1


def test_filter_select_every_variant(cuda):
    """Each kernel of csrc/filter.cu against the plain version, unaligned
    row starts included; the set of kernels reached is all of them."""
    seen = set()
    for shape, dtype, bpp, offset in [((64, 2048, 4), np.uint8, 4, 0),
                                      ((64, 2048, 4), np.uint8, 4, 4),
                                      ((64, 1024, 4), np.uint16, 8, 0),
                                      ((64, 1024, 4), np.uint16, 8, 4),
                                      ((64, 2048, 4), np.uint8, 4, 1),
                                      ((16, 100, 3), np.uint8, 3, 0)]:
        t, prev = filter_band(cuda, shape, dtype, offset + bpp, offset=offset)
        filtered_probe = torch.empty(1, dtype=torch.uint8, device=cuda)
        seen.add(K.FILTER_VARIANTS[K.filter_variant(t[0].nbytes, bpp, t.data_ptr(),
                                                    prev.data_ptr(),
                                                    filtered_probe.data_ptr())])
        types, filtered = K.filter_select(t, prev, bpp)
        p_types, p_filtered = K.filter_select_plain(t, prev, bpp)
        torch.cuda.synchronize()
        assert torch.equal(types, p_types) and torch.equal(filtered, p_filtered)
    assert seen == set(K.FILTER_VARIANTS)


def segments(rng, n, h, w):
    metas, parts, off = [], [], 0
    for _ in range(n):
        sh, sw = int(rng.integers(1, h + 1)), int(rng.integers(1, w + 1))
        px = rng.integers(0, 256, (sh, sw, 4), dtype=np.uint8)
        metas.append((int(rng.integers(0, h - sh + 1)), int(rng.integers(0, w - sw + 1)),
                      sh, sw, off, sw * 4))
        parts.append(px.reshape(-1))
        off += px.size
    return np.array(metas, np.int64), np.concatenate(parts)


# (600, 64, 333): three culling chunks, a band width off the tile and the
# 16 B line; (50, 256, 8192): the smoke's band; (500, 256, 2048): crowded.
@pytest.mark.parametrize("n,h,w", [(1, 8, 8), (12, 64, 333), (50, 256, 2048), (600, 64, 333),
                                   (50, 256, 8192), (500, 256, 2048), (40, 37, 130)])
def test_composite_segments_matches_plain(cuda, n, h, w):
    metas, srcs = (torch.from_numpy(a).to(cuda) for a in segments(np.random.default_rng(n), n, h, w))
    launches = K.composite_segments.launches
    band, ties = K.composite_segments(metas, srcs, (3, 4, 5, 0), h, w)
    p_band, p_ties = K.composite_segments_plain(metas, srcs, (3, 4, 5, 0), h, w)
    torch.cuda.synchronize()
    assert torch.equal(band, p_band) and int(ties) == int(p_ties)
    assert K.composite_segments.launches == launches + 1


def test_composite_tie_inside_a_culled_tile(cuda):
    """The exact rational tie (As 2, Ad 6, s 5, d 174) placed across a tile
    corner, beside other segments: band and tie count equal the plain
    version's (its 200 pixels and the random segments' own ties)."""
    rng = np.random.default_rng(9)
    metas, srcs = segments(rng, 30, 64, 100)
    base = np.full((10, 20, 4), (174, 174, 174, 6), np.uint8).reshape(-1)
    top = np.full((10, 20, 4), (5, 5, 5, 2), np.uint8).reshape(-1)
    off = srcs.size
    metas = np.concatenate([metas, [[11, 120, 10, 20, off, 80], [11, 120, 10, 20, off + 800, 80]]])
    srcs = np.concatenate([srcs, base, top])
    metas, srcs = torch.from_numpy(metas).to(cuda), torch.from_numpy(srcs).to(cuda)
    band, ties = K.composite_segments(metas, srcs, (0, 0, 0, 0), 64, 400)
    p_band, p_ties = K.composite_segments_plain(metas, srcs, (0, 0, 0, 0), 64, 400)
    torch.cuda.synchronize()
    assert torch.equal(band, p_band) and int(ties) == int(p_ties) >= 200


def test_grid_and_positioned_png_match_host(cuda):
    rng = np.random.default_rng(5)
    tiles = [png_from_array(rng.integers(0, 256, (72, 100, 4), dtype=np.uint8)) for _ in range(4)]
    alpha = rng.integers(0, 256, (40, 30, 4), dtype=np.uint8)
    alpha[:, :, 3] = np.linspace(30, 230, 30).astype(np.uint8)[None, :]
    cases = [
        {"inputs": tiles, "layout": {"columns": 2}, "bandHeight": 48},
        {"inputs": [PositionedImage(0, 0, tiles[0]), PositionedImage(20, 10, png_from_array(alpha)),
                    PositionedImage(60, 40, png_from_array(alpha), z_index=1)], "bandHeight": 32},
    ]
    for opts in cases:
        opts = {**opts, "outputFormat": "png"}
        counters = image_stitch_tpu_torch.EncodeCounters()
        launches = K.filter_select.launches
        got = image_stitch_tpu_torch.concat_to_buffer(opts, device=cuda, counters=counters)
        assert got == host(opts)
        assert counters.png_bands > 0 and K.filter_select.launches == launches + counters.png_bands
    # One band of the positioned case holds an exact rational tie and is
    # replayed on the host, as on the CPU.
    assert (counters.composite_bands_on_device, counters.composite_fallback_bands) == (2, 1)


def test_positioned_jpeg_and_stream_bands_match_host(cuda):
    """Bands blended on the card go to the JPEG encoder as tensors on the
    card, and are read back for stream_bands."""
    from image_stitch_tpu.core import CoreStreamingConcatenator

    rng = np.random.default_rng(6)
    opaque = rng.integers(0, 256, (64, 96, 4), dtype=np.uint8)
    opaque[:, :, 3] = 255  # no exact tie can occur over an opaque pixel
    base = png_from_array(opaque)
    alpha = rng.integers(0, 256, (40, 30, 4), dtype=np.uint8)
    alpha[:, :, 3] = np.linspace(30, 230, 30).astype(np.uint8)[None, :]
    opts = {"inputs": [PositionedImage(0, 0, base), PositionedImage(20, 10, png_from_array(alpha))],
            "bandHeight": 32, "outputFormat": "jpeg"}
    counters = image_stitch_tpu_torch.EncodeCounters()
    launches = K.fdct_quant.launches
    got = image_stitch_tpu_torch.concat_to_buffer(opts, device=cuda, counters=counters)
    assert got == host(opts)
    assert counters.composite_bands_on_device > 0
    assert K.fdct_quant.launches > launches
    bands = list(image_stitch_tpu_torch.TorchStreamingConcatenator(
        opts, device=cuda).stream_bands())
    jax_inputs = [image_stitch_tpu.types.PositionedImage(i.x, i.y, i.source)
                  for i in opts["inputs"]]
    ref = list(CoreStreamingConcatenator({**opts, "inputs": jax_inputs,
                                          "backend": "numpy"}).stream_bands())
    assert len(bands) == len(ref)
    for a, b in zip(bands, ref):
        assert type(a) is np.ndarray
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------- JPEG --- #


def jpeg_bytes(arr: np.ndarray, sampling: str, quality: int = 88) -> bytes:
    """(H, W, 3) uint8 -> a JPEG from the port's own encoder on the CPU (a
    GPU machine may have no PIL)."""
    rgba = np.concatenate([arr, np.full(arr.shape[:2] + (1,), 255, np.uint8)], axis=-1)
    return image_stitch_tpu_torch.concat_to_buffer(
        {"inputs": [png_from_array(rgba)], "layout": {"columns": 1}, "outputFormat": "jpeg",
         "jpegQuality": quality, "jpegSampling": sampling}, device="cpu")


@pytest.mark.parametrize("k,quality", [(8, 50), (24, 100), (64, 50), (64, 100)])
def test_idct_dequant_matches_plain(cuda, k, quality):
    """Coefficients over all of int16 (the range limit's wrap), a row of
    DC-only blocks, 1003 blocks a row."""
    from image_stitch_tpu_torch.codecs.jpeg.tables import quality_scaled_tables

    rng = np.random.default_rng(k + quality)
    bx = 1003
    zz = rng.integers(-(1 << 15), 1 << 15, (3 * bx, k)).astype(np.int16)
    zz[:bx, 1:] = 0
    q = torch.from_numpy(quality_scaled_tables(quality)[0].astype(np.int32)).to(cuda)
    zz = torch.from_numpy(zz).to(cuda)
    launches = K.idct_dequant.launches
    got = K.idct_dequant(zz, q, bx)
    want = K.decode_plane(zz, q, bx)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert K.idct_dequant.launches == launches + 1


@pytest.mark.parametrize("sampling", ["444", "420"])
@pytest.mark.parametrize("size,band", [((45, 67), (0, 16)), ((45, 67), (16, 45)),
                                       ((9, 6), (3, 9)), ((9, 4), (1, 8))])
def test_device_decoder_matches_cpu(cuda, sampling, size, band):
    """decode_band on the card (a band of one tile: one upload, one
    idct_dequant launch for its components, one ycc_rgba launch into a wider
    band at an x offset) against the CPU decode: bands at the image's edges
    and inside it, comp_w of 2 and 3."""
    from image_stitch_tpu_torch.codecs.jpeg.device_decoder import DeviceJpegDecoder

    rng = np.random.default_rng(size[1])
    arr = rng.integers(0, 256, size + (3,), dtype=np.uint8)
    data = jpeg_bytes(arr, sampling)
    dec = DeviceJpegDecoder(data, cuda)
    y0, y1 = band
    out = torch.zeros((y1 - y0, size[1] + 9, 4), dtype=torch.uint8, device=cuda)
    counts = K.idct_dequant.launches, K.ycc_rgba.launches
    dec.decode_band(y0, y1, return_device=True, out=out, x0=4)
    want = DeviceJpegDecoder(data).decode_band(y0, y1)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(out[:, 4 : 4 + size[1]].cpu().numpy(), want)
    assert (K.idct_dequant.launches, K.ycc_rgba.launches) == (counts[0] + 1, counts[1] + 1)


@pytest.mark.parametrize("width_off_4", [False, True])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_batched_decode_matches_plain(cuda, seed, width_off_4):
    """A mixed band (every sampling, K 8 to 64, both column passes, x0 % 4
    of 0..3, ragged widths, image edges) through idct_dequant_batch and
    ycc_rgba_batch on the card, the tables uploaded by the wrappers: planes
    and band equal the batched plain versions'; one launch each."""
    from image_stitch_tpu_torch.testing import mixed_band

    band = mixed_band(seed, width_off_4)
    jobs = K.idct_job_table(band.windows)
    coefs, qtabs = (torch.from_numpy(a).to(cuda) for a in (band.coefs, band.qtabs))
    out = torch.full((band.h, band.width, 4), 9, dtype=torch.uint8, device=cuda)
    tiles = K.ycc_tile_table(band.tiles, band.width, out.data_ptr())
    assert set(tiles[:, 3].tolist()) == ({0} if width_off_4 else {0, 1})
    counts = K.idct_dequant.launches, K.ycc_rgba.launches
    planes = K.idct_dequant_batch(coefs, qtabs, jobs,
                                  torch.zeros(band.plane_bytes, dtype=torch.uint8, device=cuda))
    K.ycc_rgba_batch(planes, tiles, out)
    torch.cuda.synchronize()
    assert (K.idct_dequant.launches, K.ycc_rgba.launches) == (counts[0] + 1, counts[1] + 1)
    want_planes = K.idct_dequant_batch_plain(coefs, qtabs, jobs, torch.zeros_like(planes))
    assert torch.equal(planes, want_planes)
    want = K.ycc_rgba_batch_plain(want_planes, tiles, torch.full_like(out, 9))
    assert torch.equal(out, want)


def test_decode_tiles_band_matches_cpu(cuda):
    """Four tiles of different sampling, K and quantizers in one band,
    through decode_tiles_band on the card, three bands in a row through a
    ring of two staging buffers: one launch of each kernel a band, the
    bytes of the CPU decode."""
    from image_stitch_tpu_torch.codecs.jpeg.device_decoder import (
        BandStaging, DeviceJpegDecoder, decode_tiles_band)

    rng = np.random.default_rng(8)
    smooth = np.tile(np.linspace(30, 220, 40)[None, :, None], (48, 1, 3)).astype(np.uint8)
    datas = [jpeg_bytes(rng.integers(0, 256, (48, 56, 3), dtype=np.uint8), "420", 88),
             jpeg_bytes(rng.integers(0, 256, (48, 33, 3), dtype=np.uint8), "444", 60),
             jpeg_bytes(smooth, "420", 95),
             jpeg_bytes(rng.integers(0, 256, (48, 24, 3), dtype=np.uint8), "420", 30)]
    x0s = [0, 56, 89, 129]
    ring_gpu, ring_cpu = BandStaging(cuda), BandStaging("cpu")
    on_gpu = [DeviceJpegDecoder(d, cuda) for d in datas]
    on_cpu = [DeviceJpegDecoder(d) for d in datas]
    assert len({tuple(d._k) for d in on_cpu}) > 1
    counts = K.idct_dequant.launches, K.ycc_rgba.launches
    for y0 in (0, 16, 32):
        got = torch.zeros((16, 153, 4), dtype=torch.uint8, device=cuda)
        want = torch.zeros((16, 153, 4), dtype=torch.uint8)
        decode_tiles_band([(d, y0, y0 + 16, x) for d, x in zip(on_gpu, x0s)], got, ring_gpu)
        decode_tiles_band([(d, y0, y0 + 16, x) for d, x in zip(on_cpu, x0s)], want, ring_cpu)
        assert torch.equal(got.cpu(), want)
    assert (K.idct_dequant.launches, K.ycc_rgba.launches) == (counts[0] + 3, counts[1] + 3)
    assert ring_gpu.waits == 1  # the third band took the first band's buffer again


@pytest.mark.parametrize("sampling,channels", [("444", 3), ("444", 4), ("420", 4)])
def test_fdct_quant_matches_plain(cuda, sampling, channels):
    from image_stitch_tpu_torch.codecs.jpeg.tables import quality_scaled_tables
    from image_stitch_tpu_torch.ops.jpeg_dct import band_to_blocks_islow, band_to_blocks_islow_420

    rng = np.random.default_rng(channels)
    band = rng.integers(0, 256, (64, 1040, channels), dtype=np.uint8)
    band[:16, :, :3] = (0, 0, 255)  # Cb = 256
    band = torch.from_numpy(band).to(cuda)
    lq, cq = (torch.from_numpy(t.astype(np.int32)).to(cuda) for t in quality_scaled_tables(85))
    plain = band_to_blocks_islow_420 if sampling == "420" else band_to_blocks_islow
    launches = K.fdct_quant.launches
    got = K.fdct_quant(band, lq, cq, sampling)
    want = plain(band, lq, cq)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True))
    assert K.fdct_quant.launches == launches + 1


@pytest.mark.parametrize("sampling", ["444", "420"])
@pytest.mark.parametrize("channels,offset", [(3, 0), (3, 4), (4, 0), (4, 4), (5, 0)])
@pytest.mark.parametrize("width", [8, 16, 24, 264, 8192])
def test_fdct_quant_tiles_and_loads_match_plain(cuda, sampling, channels, offset, width):
    """Widths of one block, off the 128-pixel tile and at the grid's full
    width; pixel strides of 3, 4 and 5 bytes, the band at an aligned address
    and 4 B past one, so that every load variant runs; pure blue (Cb = 256),
    0 and 255 areas."""
    from image_stitch_tpu_torch.codecs.jpeg.tables import quality_scaled_tables
    from image_stitch_tpu_torch.ops.jpeg_dct import band_to_blocks_islow, band_to_blocks_islow_420

    if sampling == "420":
        width = -(-width // 16) * 16
    rng = np.random.default_rng(width + channels)
    h = 32
    data = rng.integers(0, 256, (h, width, channels), dtype=np.uint8)
    data[:8, :, :3] = (0, 0, 255)
    data[8:12] = 0
    data[12:16] = 255
    store = torch.empty(data.size + 16, dtype=torch.uint8, device=cuda)
    band = store[offset : offset + data.size].view(data.shape)
    band.copy_(torch.from_numpy(data))
    want_variant = {(3, 0): "rgb_vec8", (4, 0): "rgba_vec16"}.get((channels, offset), "bytes")
    assert K.FDCT_VARIANTS[K.fdct_variant(channels, band.data_ptr())] == want_variant
    lq, cq = (torch.from_numpy(t.astype(np.int32)).to(cuda) for t in quality_scaled_tables(85))
    plain = band_to_blocks_islow_420 if sampling == "420" else band_to_blocks_islow
    got = K.fdct_quant(band, lq, cq, sampling)
    want = plain(band, lq, cq)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True))


@pytest.mark.parametrize("quality", [1, 50, 100])
def test_fdct_quant_at_the_tables_ends(cuda, quality):
    """Quantizers of 255 (q1) and 1 (q100): the reciprocal's widest and
    narrowest divisors, on random bytes and 0/255 checkers."""
    from image_stitch_tpu_torch.codecs.jpeg.tables import quality_scaled_tables
    from image_stitch_tpu_torch.ops.jpeg_dct import band_to_blocks_islow

    rng = np.random.default_rng(quality)
    data = rng.integers(0, 256, (64, 512, 4), dtype=np.uint8)
    data[:32] = ((np.indices((32, 512)).sum(0) & 1) * 255).astype(np.uint8)[..., None]
    band = torch.from_numpy(data).to(cuda)
    lq, cq = (torch.from_numpy(t.astype(np.int32)).to(cuda)
              for t in quality_scaled_tables(quality))
    got = K.fdct_quant(band, lq, cq, "444")
    want = band_to_blocks_islow(band, lq, cq)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True))


@pytest.mark.parametrize("sampling", ["444", "420"])
@pytest.mark.parametrize("n_groups,carried", [(1, False), (8, False), (1, True)])
def test_symbol_streams_matches_plain(cuda, sampling, n_groups, carried):
    from image_stitch_tpu_torch.codecs.jpeg import tables as T
    from image_stitch_tpu_torch.ops import jpeg_entropy_device as E

    rng = np.random.default_rng(n_groups)
    n = 1024
    luma = 4 if sampling == "420" else 1

    def blocks(cnt):
        zz = rng.integers(-60, 61, (cnt, 64)) * (rng.random((cnt, 64)) < 0.2)
        zz[::5, 1:] = 0
        zz[1::7, 2:34] = 0  # a run of 32 zeros
        zz[2::7, 2:19] = 0  # 17
        zz[3::7, 63] = 9    # nonzero at 63
        nat = np.zeros_like(zz)
        nat[:, T.ZIGZAG] = zz
        return torch.from_numpy(nat.astype(np.int16)).to(cuda)

    y, cb, cr = blocks(luma * n), blocks(n), blocks(n)
    tables = [T.build_huffman_codes(bits, vals) for bits, vals in (
        (T.STD_DC_LUMA_BITS, T.STD_DC_LUMA_VALS), (T.STD_AC_LUMA_BITS, T.STD_AC_LUMA_VALS),
        (T.STD_DC_CHROMA_BITS, T.STD_DC_CHROMA_VALS), (T.STD_AC_CHROMA_BITS, T.STD_AC_CHROMA_VALS))]
    luts = E.build_entropy_luts(*tables, cuda)
    prev = torch.tensor([100, -7, 3], dtype=torch.int32, device=cuda) if carried else None
    launches = K.symbol_streams.launches
    got = K.symbol_streams(y, cb, cr, luts, n_groups, sampling, prev)
    want = E.symbol_streams_plain(y, cb, cr, luts, n_groups, sampling, prev)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[1].sum(dim=1, dtype=torch.int32))
    assert got[3].tolist() == [int(c[-1, 0]) for c in (y, cb, cr)]
    assert K.symbol_streams.launches == launches + 1


def standard_luts(device):
    from image_stitch_tpu_torch.codecs.jpeg import tables as T
    from image_stitch_tpu_torch.ops import jpeg_entropy_device as E

    tables = [T.build_huffman_codes(bits, vals) for bits, vals in (
        (T.STD_DC_LUMA_BITS, T.STD_DC_LUMA_VALS), (T.STD_AC_LUMA_BITS, T.STD_AC_LUMA_VALS),
        (T.STD_DC_CHROMA_BITS, T.STD_DC_CHROMA_VALS), (T.STD_AC_CHROMA_BITS, T.STD_AC_CHROMA_VALS))]
    return E.build_entropy_luts(*tables, device)


@pytest.mark.parametrize("sampling", ["444", "420"])
@pytest.mark.parametrize("n_mcu,n_groups,carried", [(1, 1, False), (3, 3, True), (1037, 1, True),
                                                   (1037, 17, False), (4096, 32, False)])
def test_symbol_streams_edges_match_plain(cuda, sampling, n_mcu, n_groups, carried):
    """Block counts that are no multiple of the CTA's 8 warps, with every
    edge of the mask arithmetic among the blocks: all zeros, 63 nonzeros,
    runs of 15, 16, 17, 32 and 48 zeros, runs to position 63, the ballots'
    word boundary, +-32767."""
    from image_stitch_tpu_torch.codecs.jpeg import tables as T
    from image_stitch_tpu_torch.ops import jpeg_entropy_device as E

    rng = np.random.default_rng(n_mcu)
    luma = 4 if sampling == "420" else 1
    carried = carried and n_groups == 1

    def blocks(cnt):
        zz = rng.integers(-60, 61, (cnt, 64)) * (rng.random((cnt, 64)) < 0.25)
        zz[:, 0] = rng.integers(-1023, 1024, cnt)
        edges = [np.zeros(64), np.r_[7, np.arange(1, 64)]]
        for run in (15, 16, 17, 32, 48):
            row = np.zeros(64)
            row[1], row[2 + run] = 3, -5
            edges.append(row)
        for first in (46, 47):
            row = np.zeros(64)
            row[first], row[63] = 1, -1
            edges.append(row)
        edges.append(np.r_[np.zeros(31), 4, -4, np.zeros(31)])
        edges.append(np.r_[0, 32767, -32767, np.zeros(60), 32767])
        for i, row in enumerate(edges):
            zz[i::13, 1:] = row[1:]
        nat = np.zeros_like(zz)
        nat[:, T.ZIGZAG] = zz
        return torch.from_numpy(nat.astype(np.int16)).to(cuda)

    y, cb, cr = blocks(luma * n_mcu), blocks(n_mcu), blocks(n_mcu)
    luts = standard_luts(cuda)
    prev = torch.tensor([517, -66, 31], dtype=torch.int32, device=cuda) if carried else None
    got = K.symbol_streams(y, cb, cr, luts, n_groups, sampling, prev)
    want = E.symbol_streams_plain(y, cb, cr, luts, n_groups, sampling, prev)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[1].sum(dim=1, dtype=torch.int32))
    assert got[3].tolist() == [int(c[-1, 0]) for c in (y, cb, cr)]


@pytest.mark.parametrize("group_len,n_groups,bit_base", [
    (3, 1, None), (3, 7, None), (18, 4, None), (45, 12, None), (42, 32, None), (1023, 3, None),
    (1024, 2, None), (1025, 2, None), (2049, 3, None), (3072, 32, None), (8192, 12, None),
    (98304, 1, None), (1, 2000, None), (100, 333, None), (3, 1, 1), (1030, 1, 7), (5000, 1, 0),
    (98304, 1, 5), (147456, 1, 3)])
def test_group_layout_matches_plain(cuda, group_len, n_groups, bit_base):
    """Restart groups and the carried stream: group lengths off the warp
    and off the 1024-block chunk, more chunks than one wave of CTAs, blocks
    over the 768-bit budget; run three times on one stream, since a launch
    leaves the ticket counter for the next."""
    from image_stitch_tpu_torch.ops import jpeg_entropy_device as E

    rng = np.random.default_rng(group_len + n_groups)
    for rep in range(3):
        bits = rng.integers(4, 400, group_len * n_groups)
        bits[rng.random(bits.size) < 0.02] = 1500 + rep
        bits = torch.from_numpy(bits.astype(np.int32)).to(cuda)
        base = None if bit_base is None else torch.tensor(bit_base, device=cuda)
        launches = K.group_layout.launches
        got = K.group_layout(bits, n_groups, base)
        want = E.group_layout_plain(bits, n_groups, base)
        torch.cuda.synchronize()
        assert K.group_layout.launches == launches + 1
        for g, w in zip(got, want, strict=True):
            assert (g is None and w is None) or (g.dtype == w.dtype and torch.equal(g, w))


def test_group_layout_on_two_streams(cuda):
    """Each stream has its own scratch buffer: launches on two streams do
    not share a ticket counter."""
    from image_stitch_tpu_torch.ops import jpeg_entropy_device as E

    bits = torch.from_numpy(np.random.default_rng(1).integers(0, 900, 40000).astype(np.int32))
    bits = bits.to(cuda)
    want = E.group_layout_plain(bits, 8)
    torch.cuda.synchronize()
    side = torch.cuda.Stream(cuda)
    outs = []
    for _ in range(4):
        outs.append(K.group_layout(bits, 8))
        with torch.cuda.stream(side):
            outs.append(K.group_layout(bits, 8))
    torch.cuda.synchronize()
    for got in outs:
        assert all(torch.equal(g, w) for g, w in zip(got[:3], want[:3]))


@pytest.mark.parametrize("sampling,ri", [("444", 0), ("444", 1), ("420", 2)])
def test_band_packs_in_three_launches(cuda, sampling, ri):
    """A band through the encoder: symbol_streams, group_layout and
    pack_merge launch once each per dispatch, and the bytes are the CPU
    path's."""
    rng = np.random.default_rng(ri)
    tiles = [png_from_array(rng.integers(0, 256, (80, 96, 4), dtype=np.uint8)) for _ in range(2)]
    opts = {"inputs": tiles, "layout": {"columns": 2}, "outputFormat": "jpeg",
            "jpegSampling": sampling, "jpegRestartIntervalRows": ri, "bandHeight": 32}
    wrappers = (K.symbol_streams, K.group_layout, K.pack_merge)
    before = [w.launches for w in wrappers]
    got = image_stitch_tpu_torch.concat_to_buffer(opts, device=cuda)
    counts = [w.launches - b for w, b in zip(wrappers, before)]
    assert counts[0] == counts[1] == counts[2] > 0
    assert got == image_stitch_tpu_torch.concat_to_buffer(opts, device="cpu")


@pytest.mark.parametrize("ri,sampling", [(1, "420"), (0, "444")])
def test_jpeg_tiles_grid_matches_host(cuda, ri, sampling):
    """A grid of JPEG tiles to JPEG: every band decoded on the card and
    encoded there, bytes equal to the host tier's."""
    rng = np.random.default_rng(ri)
    tiles = [jpeg_bytes(rng.integers(0, 256, (64, 80, 3), dtype=np.uint8), sampling)
             for _ in range(4)]
    opts = {"inputs": tiles, "layout": {"columns": 2}, "outputFormat": "jpeg",
            "jpegRestartIntervalRows": ri, "bandHeight": 32}
    counts = [w.launches for w in (K.idct_dequant, K.ycc_rgba, K.fdct_quant, K.symbol_streams)]
    got = image_stitch_tpu_torch.concat_to_buffer(opts, device=cuda)
    assert got == host(opts)
    after = [w.launches for w in (K.idct_dequant, K.ycc_rgba, K.fdct_quant, K.symbol_streams)]
    # 2 tile rows of 2 bands: one launch of each decode kernel a band,
    # whatever the tiles and components.
    assert after[0] - counts[0] == 4 and after[1] - counts[1] == 4
    assert after[2] > counts[2] and after[3] > counts[3]


@pytest.mark.parametrize("case", ["jpeg_tiles", "positioned_jpeg", "positioned_png", "grid_png"])
def test_the_default_device_string(cuda, case):
    """device="cuda", the string every entry point defaults to: resolved to
    the current card with its index, so the JPEG-tile decode's guard finds
    the decoders, the staging ring and the band on one device. A JPEG-tile
    grid (the band of rows 48-96 crosses a tile boundary) decodes every
    band on the card; a positioned job blends there; both encoders run
    there; each gives the bytes of the JAX package's host tier."""
    rng = np.random.default_rng(17)
    if case == "jpeg_tiles":
        tiles = [jpeg_bytes(rng.integers(0, 256, (64, 80, 3), dtype=np.uint8), "420")
                 for _ in range(4)]
        opts = {"inputs": tiles, "layout": {"columns": 2}, "outputFormat": "jpeg",
                "bandHeight": 48}
    elif case == "grid_png":
        tiles = [png_from_array(rng.integers(0, 256, (40, 56, 4), dtype=np.uint8))
                 for _ in range(4)]
        opts = {"inputs": tiles, "layout": {"columns": 2}, "outputFormat": "png",
                "bandHeight": 32}
    else:
        base = rng.integers(0, 256, (64, 96, 4), dtype=np.uint8)
        base[:, :, 3] = 255
        sprite = rng.integers(0, 256, (40, 30, 4), dtype=np.uint8)
        sprite[:, :, 3] = np.linspace(30, 230, 30).astype(np.uint8)[None, :]
        opts = {"inputs": [PositionedImage(0, 0, png_from_array(base)),
                           PositionedImage(20, 10, png_from_array(sprite))],
                "bandHeight": 32, "outputFormat": case.split("_")[1]}
    counters = image_stitch_tpu_torch.EncodeCounters()
    got = image_stitch_tpu_torch.concat_to_buffer(opts, device="cuda", counters=counters)
    assert got == host(opts)
    assert counters.host_tier_bands == 0
    if case == "jpeg_tiles":
        assert counters.decode_bands_on_device == 3 and counters.decode_tiles_opened == 4
        assert counters.decode_staged_uploads == 4 and counters.bands == 3
    elif case == "grid_png":
        assert counters.png_bands == 3
    else:
        assert counters.composite_bands_on_device > 0
        assert (counters.bands if case == "positioned_jpeg" else counters.png_bands) == 2


# ---------------------------------------------------------- packed bands --- #


@pytest.mark.parametrize("ri", [0, 2])
def test_packed_band_on_the_card_matches_rgba(cuda, ri):
    """An (H, W) uint32 band of little-endian RGBA on the card, fed in bands
    that hold rows back, is encoded as its RGBA view: the bytes of the RGBA
    band on the host tier."""
    from image_stitch_tpu_torch.codecs.jpeg.encoder import (StreamingJpegEncoder,
                                                            TorchStreamingJpegEncoder)

    img = np.random.default_rng(ri).integers(0, 256, (40, 56, 4), dtype=np.uint8)
    words = torch.from_numpy(img.view(np.uint32).reshape(40, 56).copy()).to(cuda)
    ref = StreamingJpegEncoder(56, 40, 85, restart_interval_rows=ri)
    want = b"".join(ref.encode_band(img)) + b"".join(ref.finish())
    enc = TorchStreamingJpegEncoder(56, 40, 85, device=cuda, restart_interval_rows=ri)
    got = b"".join(b"".join(enc.encode_band(words[y : y + 12])) for y in range(0, 40, 12))
    assert got + b"".join(enc.finish()) == want


# ------------------------------------------------------ staged uploads --- #


def test_staged_host_bands_on_the_card(cuda, monkeypatch):
    """Six 256 x 10000 RGBA host bands through the encoder's staging ring:
    the host tier's bytes, each source array written over as soon as its
    band is submitted, every quantize on the RGBA 16 B load variant. The
    uploaded band is dropped before the symbol slots are allocated: given
    the same bands as tensors that the caller holds, the peak of device
    memory is higher by about a band."""
    from image_stitch_tpu_torch.codecs.jpeg.encoder import (StreamingJpegEncoder,
                                                            TorchStreamingJpegEncoder)

    h, w, n = 256, 10000, 6
    rng = np.random.default_rng(16)
    ramp = np.linspace(0, 255, w, dtype=np.float32)[None, :]
    bands = []
    for i in range(n):
        b = np.empty((h, w, 4), np.uint8)
        b[..., 0] = ramp
        b[..., 1] = np.linspace(0, 255, h, dtype=np.float32)[:, None] * (i + 1) / n
        b[..., 2] = 128
        b[..., 3] = 255
        bands.append((b.astype(np.int16) + rng.integers(-6, 7, b.shape)).clip(0, 255)
                     .astype(np.uint8))
    ref = StreamingJpegEncoder(w, h * n, 85)
    want = b"".join(b"".join(ref.encode_band(b)) for b in bands) + b"".join(ref.finish())

    variants = []
    real_variant = K.fdct_variant

    def fdct_variant(ch, address):
        variants.append(real_variant(ch, address))
        return variants[-1]

    monkeypatch.setattr(K, "fdct_variant", fdct_variant)

    def encode(as_tensors: bool):
        counters = image_stitch_tpu_torch.EncodeCounters()
        torch.cuda.synchronize(cuda)
        base = torch.cuda.memory_allocated(cuda)
        torch.cuda.reset_peak_memory_stats(cuda)
        enc = TorchStreamingJpegEncoder(w, h * n, 85, device=cuda, counters=counters)
        out = []
        for b in bands:
            if as_tensors:
                t = torch.from_numpy(b).to(cuda)
                out += enc.encode_band(t)
                del t
            else:
                src = b.copy()
                out += enc.encode_band(src)
                src[...] = 0
        out += enc.finish()
        torch.cuda.synchronize(cuda)
        return b"".join(out), counters, torch.cuda.max_memory_allocated(cuda) - base

    got, counters, peak = encode(False)
    assert got == want
    assert counters.staged_uploads == counters.bands == n
    assert variants == [2] * n  # rgba_vec16
    got_t, counters_t, peak_t = encode(True)
    assert got_t == want and counters_t.staged_uploads == 0
    print(f"staged uploads {counters.staged_uploads}, staging stalls {counters.staging_stalls}; "
          f"device peak over the encode {peak / 1e6:.3f} MB from host bands, "
          f"{peak_t / 1e6:.3f} MB from held tensors")
    assert counters.staging_stalls <= counters.staged_uploads - 2
    assert peak_t - peak > h * w * 4 // 2


# ----------------------------------------------------------------- mesh --- #


def virtual_mesh(cuda):
    """A 2 x 2 mesh of four virtual shards on one card, a stream each."""
    from image_stitch_tpu_torch.parallel.mesh import Mesh

    return Mesh([[cuda, cuda], [cuda, cuda]])


def meshes(cuda):
    from image_stitch_tpu_torch.parallel.mesh import make_mesh

    return {"virtual 2x2": virtual_mesh(cuda), "every card": make_mesh(torch.cuda.device_count())}


@pytest.mark.parametrize("fmt,ri,sampling", [("png", 0, "444"), ("jpeg", 0, "444"),
                                             ("jpeg", 1, "444"), ("jpeg", 2, "420")])
def test_mesh_grid_matches_host(cuda, fmt, ri, sampling):
    """A grid over the virtual mesh and over every card: the host tier's
    bytes; filter select once per non-empty slab, the encoder's kernels once
    per dispatch on a shard; as many bands coded on the host (full-range
    noise overflows the carried stream's budget) as on one card."""
    rng = np.random.default_rng(9)
    tiles = [png_from_array(rng.integers(0, 256, (72, 100, 4), dtype=np.uint8)) for _ in range(4)]
    opts = {"inputs": tiles, "layout": {"columns": 2}, "bandHeight": 48, "outputFormat": fmt,
            "jpegRestartIntervalRows": ri, "jpegSampling": sampling}
    want = host(opts)
    single = image_stitch_tpu_torch.EncodeCounters()
    assert image_stitch_tpu_torch.concat_to_buffer(opts, device=cuda, counters=single) == want
    for name, mesh in meshes(cuda).items():
        counters = image_stitch_tpu_torch.EncodeCounters()
        before = {w: w.launches for w in (K.filter_select, K.pack_merge, K.fdct_quant)}
        got = image_stitch_tpu_torch.concat_to_buffer({**opts, "mesh": mesh}, device=cuda,
                                                      counters=counters)
        assert got == want, name
        n = {w: w.launches - b for w, b in before.items()}
        assert n[K.filter_select] == counters.mesh_slabs
        assert n[K.pack_merge] == counters.mesh_dispatches + counters.repacks
        assert n[K.fdct_quant] == counters.mesh_dispatches
        assert counters.host_tier_bands == 0
        assert counters.host_fallback_bands == single.host_fallback_bands


@pytest.mark.parametrize("fmt", ["png", "jpeg"])
def test_mesh_positioned_matches_host(cuda, fmt):
    """Sprites across the slabs' edges, composited on the virtual shards and
    encoded where they lie."""
    rng = np.random.default_rng(6)
    opaque = rng.integers(0, 256, (64, 96, 4), dtype=np.uint8)
    opaque[:, :, 3] = 255
    alpha = rng.integers(0, 256, (40, 30, 4), dtype=np.uint8)
    alpha[:, :, 3] = np.linspace(30, 230, 30).astype(np.uint8)[None, :]
    opts = {"inputs": [PositionedImage(0, 0, png_from_array(opaque)),
                       PositionedImage(20, 10, png_from_array(alpha))],
            "bandHeight": 32, "outputFormat": fmt, "jpegRestartIntervalRows": 1}
    counters = image_stitch_tpu_torch.EncodeCounters()
    before = K.composite_segments.launches
    got = image_stitch_tpu_torch.concat_to_buffer({**opts, "mesh": virtual_mesh(cuda)},
                                                  device=cuda, counters=counters)
    assert got == host(opts)
    assert counters.composite_bands_on_device == 2
    # Slabs of 8 rows (PNG) or one restart group (JPEG): four a band.
    assert K.composite_segments.launches - before == 8


def test_mesh_fused_steps_match_one_device_and_plain(cuda):
    """The sharded steps over the virtual mesh: one grid_dual launch per
    non-empty slab, and no filter_select or fdct_quant launch; each equal
    to one card's step and to the plain step on the CPU."""
    from image_stitch_tpu_torch.codecs.jpeg.tables import quality_scaled_tables
    from image_stitch_tpu_torch.ops import fused
    from image_stitch_tpu_torch.parallel import mesh

    rng = np.random.default_rng(4)
    tiles = torch.from_numpy(rng.integers(0, 256, (2, 4, 24, 32, 4), dtype=np.uint8))
    prev = torch.from_numpy(rng.integers(0, 256, 4 * 32 * 4, dtype=np.uint8))
    lq, cq = (torch.from_numpy(q) for q in quality_scaled_tables(85))
    cpu_args = (tiles, prev, lq, cq)
    for name, align, pick in (("dual", 8, (0, 1, 2, 3)), ("png", 1, (0, 1)),
                              ("jpeg", 8, (0, 2, 3))):
        args = [cpu_args[i].to(cuda) for i in pick]
        plain = getattr(fused, f"fused_grid_{name}_step")(*[cpu_args[i] for i in pick])
        one = getattr(fused, f"fused_grid_{name}_step")(*args)
        before = launch_counts()
        sharded = getattr(mesh, f"shard_grid_{name}_step")(virtual_mesh(cuda))(*args)
        torch.cuda.synchronize()
        slabs = sum(r1 > r0 for r0, r1 in mesh.row_slabs(48, 4, align))
        assert launch_counts(before) == (slabs, 0, 0), name
        for p, o, s in zip(plain, one, sharded, strict=True):
            assert s.device == cuda
            assert torch.equal(o.cpu(), p) and torch.equal(s.cpu(), p)


def test_backend_jpeg_quantize_on_the_card(cuda):
    """``TorchBackend``'s JPEG quantize on the card, alone and over the
    virtual mesh (one fdct_quant launch per band or non-empty slab), from a
    host array and from a tensor: the CPU backend's blocks."""
    from image_stitch_tpu_torch.codecs.jpeg.tables import quality_scaled_tables
    from image_stitch_tpu_torch.ops.device import TorchBackend

    band = np.random.default_rng(8).integers(0, 256, (48, 72, 4), dtype=np.uint8)
    lq, cq = quality_scaled_tables(50)
    want = TorchBackend("cpu").jpeg_quantize_band(band, lq, cq)
    for mesh, launches in ((None, 1), (virtual_mesh(cuda), 4)):
        backend = TorchBackend(cuda, mesh=mesh)
        for given in (band, torch.from_numpy(band).to(cuda)):
            before = K.fdct_quant.launches
            got = backend.jpeg_quantize_band(given, lq, cq)
            assert K.fdct_quant.launches - before == launches
            for a, b in zip(got, want, strict=True):
                np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ grid_dual --- #


def launch_counts(before=(0, 0, 0)) -> tuple[int, int, int]:
    """(grid_dual, filter_select, fdct_quant) launches since ``before``."""
    now = (K.grid_dual.launches, K.filter_select.launches, K.fdct_quant.launches)
    return tuple(a - b for a, b in zip(now, before))


# entry()'s shape, a tile height that cuts the strips, 40 B tile rows (4 B
# copies), two windows a CTA, rows and a width off 8, the smoke's band.
GRID_SHAPES = [(2, 4, 64, 64), (2, 3, 12, 40), (2, 4, 8, 10), (1, 9, 8, 1100), (3, 2, 7, 13),
               (1, 8, 256, 1024)]


@pytest.mark.parametrize("shape", GRID_SHAPES)
def test_grid_dual_matches_plain(cuda, shape):
    """Each half alone and both, over all rows and over each non-empty slab
    of a four-shard split (the smoke's band: both halves, all rows): equal
    to ``grid_dual_plain`` on the CPU, one grid_dual launch each and no
    filter_select or fdct_quant launch."""
    from image_stitch_tpu_torch.codecs.jpeg.tables import quality_scaled_tables
    from image_stitch_tpu_torch.parallel.mesh import row_slabs
    from image_stitch_tpu_torch.testing import grid_tiles

    gy, gx, th, tw = shape
    h, w = gy * th, gx * tw
    tiles = torch.from_numpy(grid_tiles(shape, seed=sum(shape)))
    prev = torch.from_numpy(np.random.default_rng(1).integers(0, 256, w * 4, dtype=np.uint8))
    lq, cq = (torch.from_numpy(q) for q in quality_scaled_tables(85))
    args = [t.to(cuda) for t in (tiles, prev, lq, cq)]
    halves = [(True, False)] + ([(False, True), (True, True)] if h % 8 == w % 8 == 0 else [])
    if h * w > 1 << 20:
        halves = [(True, True)]
    for png, jpeg in halves:
        ranges = [(0, h)]
        if h * w <= 1 << 20:
            ranges += [s for s in row_slabs(h, 4, 8 if jpeg else 1) if s[1] > s[0]]
        for r0, r1 in ranges:
            before = launch_counts()
            got = K.grid_dual(*args, r0, r1, png, jpeg)
            torch.cuda.synchronize()
            assert launch_counts(before) == (1, 0, 0)
            want = K.grid_dual_plain(tiles, prev, lq, cq, r0, r1, png, jpeg)
            for a, b in zip(got, want, strict=True):
                assert torch.equal(a.cpu(), b), (png, jpeg, r0, r1)


@pytest.mark.parametrize("tw,offset,variant", [(64, 0, "vec16"), (10, 0, "words"),
                                               (64, 4, "words"), (64, 1, "composition")])
def test_grid_dual_variants_on_the_card(cuda, tw, offset, variant):
    """The dispatch on shape: 16 B and 4 B copies launch grid_dual; a tile
    stack off a 4 B boundary takes the composition (filter_select and
    fdct_quant, no grid_dual). Each equals the plain step."""
    from image_stitch_tpu_torch.codecs.jpeg.tables import quality_scaled_tables
    from image_stitch_tpu_torch.ops import fused
    from image_stitch_tpu_torch.testing import grid_tiles

    shape = (2, 4, 16, tw)
    tiles = torch.from_numpy(grid_tiles(shape, seed=tw + offset))
    store = torch.zeros(tiles.numel() + 32, dtype=torch.uint8, device=cuda)
    t = store[offset:offset + tiles.numel()].view(*shape, 4)
    t.copy_(tiles.to(cuda))
    prev = torch.zeros(4 * tw * 4, dtype=torch.uint8)
    lq, cq = (torch.from_numpy(q) for q in quality_scaled_tables(85))
    assert K.GRID_DUAL_VARIANTS[K.grid_dual_variant(tw, t.data_ptr())] == variant
    before = launch_counts()
    got = fused.fused_grid_dual_step(t, prev.to(cuda), lq.to(cuda), cq.to(cuda))
    torch.cuda.synchronize()
    assert launch_counts(before) == ((0, 1, 1) if variant == "composition" else (1, 0, 0))
    want = fused.fused_grid_dual_step(tiles, prev, lq, cq)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a.cpu(), b)


def test_fused_steps_launch_grid_dual_once(cuda):
    """On a CUDA tile stack each fused step is one grid_dual launch, with no
    filter_select or fdct_quant launch; its ``*_plain`` composition
    launches those two, and both equal the step on the CPU."""
    from image_stitch_tpu_torch.codecs.jpeg.tables import quality_scaled_tables
    from image_stitch_tpu_torch.ops import fused
    from image_stitch_tpu_torch.testing import grid_tiles

    tiles = torch.from_numpy(grid_tiles((2, 4, 64, 64), seed=5))
    prev = torch.from_numpy(np.random.default_rng(5).integers(0, 256, 1024, dtype=np.uint8))
    lq, cq = (torch.from_numpy(q) for q in quality_scaled_tables(85))
    cpu = {"png": (tiles, prev), "jpeg": (tiles, lq, cq), "dual": (tiles, prev, lq, cq)}
    for name, args in cpu.items():
        on_card = [a.to(cuda) for a in args]
        want = getattr(fused, f"fused_grid_{name}_step")(*args)
        before = launch_counts()
        got = getattr(fused, f"fused_grid_{name}_step")(*on_card)
        torch.cuda.synchronize()
        assert launch_counts(before) == (1, 0, 0), name
        before = launch_counts()
        composed = getattr(fused, f"fused_grid_{name}_step_plain")(*on_card)
        torch.cuda.synchronize()
        n = (name != "jpeg", name != "png")
        assert launch_counts(before) == (0, int(n[0]), int(n[1])), name
        for a, b, c in zip(got, composed, want, strict=True):
            assert torch.equal(a.cpu(), c) and torch.equal(b.cpu(), c)


def test_mesh_jpeg_tiles_match_host(cuda):
    """JPEG tiles decoded on the mesh's first device, each shard encoding its
    rows from there."""
    rng = np.random.default_rng(2)
    tiles = [jpeg_bytes(rng.integers(0, 256, (64, 80, 3), dtype=np.uint8), "420")
             for _ in range(4)]
    opts = {"inputs": tiles, "layout": {"columns": 2}, "outputFormat": "jpeg",
            "jpegRestartIntervalRows": 1, "bandHeight": 32}
    counters = image_stitch_tpu_torch.EncodeCounters()
    got = image_stitch_tpu_torch.concat_to_buffer({**opts, "mesh": virtual_mesh(cuda)},
                                                  device=cuda, counters=counters)
    assert got == host(opts)
    assert counters.decode_bands_on_device == 4 and counters.mesh_dispatches == 16


def test_mesh_refusals_on_the_card(cuda):
    from image_stitch_tpu_torch.errors import StitchError
    from image_stitch_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(StitchError, match="devices"):
        make_mesh(torch.cuda.device_count() + 1)
    opts = {"inputs": [png_from_array(np.zeros((8, 8, 4), np.uint8))], "layout": {"columns": 1}}
    with pytest.raises(StitchError, match="mesh on cuda devices"):
        image_stitch_tpu_torch.concat_to_buffer({**opts, "mesh": virtual_mesh(cuda)},
                                                device="cpu")
    # An int mesh on the card counts the cards, never CPU shards.
    mesh = image_stitch_tpu_torch.TorchStreamingConcatenator({**opts, "mesh": 1}, device=cuda).mesh
    assert mesh.flat() == [cuda]


@pytest.fixture
def fresh_policy(monkeypatch, tmp_path):
    """The auto policy's session cache emptied and its persistent cache in
    ``tmp_path``; no policy variable set."""
    from image_stitch_tpu_torch.ops import backend as B

    monkeypatch.setattr(B, "_LINK_PROFILES", {})
    for var in ("STITCH_TPU_PREFER_DEVICE", "STITCH_TPU_LINK_PROFILE",
                "STITCH_TPU_PROBE_BUDGET_S"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    return B


def test_link_probe_measures_the_card(cuda, fresh_policy):
    """The budgeted probe (a child process) on the card: a CUDA platform,
    more than 1,000 MB/s up and down, under 1 ms of latency, persisted."""
    prof = fresh_policy.probe_link_profile(cuda)
    assert prof is not None and not prof.timed_out
    assert prof.platform.startswith("cuda") and torch.cuda.get_device_name(cuda) in prof.platform
    assert prof.h2d_mbps > 1000 and prof.d2h_mbps > 1000 and prof.latency_ms < 1.0
    assert fresh_policy.get_link_profile(cuda).platform == prof.platform


def test_auto_over_the_threshold_picks_the_card(cuda, fresh_policy):
    """"auto" at the threshold resolves to "torch" on the card's measured
    link, and under it to the host tier."""
    t = fresh_policy.AUTO_DEVICE_THRESHOLD_PIXELS
    assert fresh_policy.resolve_backend_name("auto", t, cuda) == "torch"
    assert fresh_policy.resolve_backend_name("auto", t - 1, cuda) == "numpy"
    prof = fresh_policy.get_link_profile(cuda)
    assert fresh_policy.decide_auto_backend(t, True, prof) == "torch"
