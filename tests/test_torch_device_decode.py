"""JPEG tiles decoded by the port's device tier, against the JAX package.

- ``DeviceJpegDecoder.decode_band`` on the CPU (the plain versions of
  ``idct_dequant`` and ``ycc_rgba``) against the JAX package's
  ``DeviceJpegDecoder`` and the owned host decoder: 4:4:4, 4:2:2, 4:2:0,
  gray, odd sizes, any band split, progressive, K truncation.
- ``decode_tiles_band`` (a band of several tiles through one staged upload
  and one call of each batched kernel) against per-tile ``decode_band`` and
  the owned decoder: tiles of different K, quantizer tables and samplings.
- ``concat_to_buffer(..., device="cpu")`` on grids of JPEG tiles to JPEG
  against ``image_stitch_tpu.concat_to_buffer`` with the numpy and jax
  backends: the fast path (counted), bands crossing tile boundaries, mixed
  PNG and JPEG, duplicate inputs, the off switch, restart groups,
  background holes.
- The JAX package's byte-packed handoff (``STITCH_TPU_DECODE_PACKED=1``,
  tests/integration/test_device_decode_grid.py:137-170 and
  tests/unit/test_jpeg_idct_device.py:294-318): the port does not read the
  variable, since its bands already lie on the card as interleaved RGBA;
  its bytes equal the JAX package's packed runs, on a grid, with restart
  groups and on a stream that mixes device and host plans, and the port's
  encoder takes the JAX package's packed bands as RGBA.
- The encoder's tensor bands: alone, alternating with host bands, and on
  the wrong device (which raises).
- The transport straight from the native scan (int16 in zigzag order, with
  each component's last nonzero position and peak) against the natural
  route (the int32 scan and a NumPy pass): the same blocks, K, flags and
  staged bytes on baseline streams of every kind; progressive streams and
  values past int16 take the natural route; the grid counts its tiles.
- Streams past the device tier's bounds: DC accumulation to |coef| >= 2^15
  is decoded on the host tier, and |coef * q| past the JAX package's
  M_SAFE (but |coef| < 2^15) on the port's device tier; both give the JAX
  package's bytes.

Everything is integer: bytes must be equal.
"""

import io

import numpy as np
import pytest
import torch
from PIL import Image

import image_stitch_tpu
import image_stitch_tpu_torch
from image_stitch_tpu.codecs.jpeg.device_decoder import DeviceJpegDecoder as JaxDecoder
from image_stitch_tpu.codecs.jpeg.owned_decoder import decode_baseline_jpeg
from image_stitch_tpu_torch.codecs.jpeg import device_decoder
from image_stitch_tpu_torch.codecs.jpeg import tables as T
from image_stitch_tpu_torch.codecs.jpeg.device_decoder import DeviceJpegDecoder
from image_stitch_tpu_torch.codecs.jpeg.encoder import TorchStreamingJpegEncoder
from image_stitch_tpu_torch.codecs.jpeg.huffman import BitPacker, HuffmanEncoder

torch.set_num_threads(1)


def photo(h: int, w: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    arr = np.empty((h, w, 3), np.uint8)
    arr[..., 0] = np.linspace(0, 255, w, dtype=np.float32)[None, :].astype(np.uint8)
    arr[..., 1] = np.linspace(0, 255, h, dtype=np.float32)[:, None].astype(np.uint8)
    arr[..., 2] = rng.integers(0, 256, (h, w), dtype=np.uint8)
    return arr


def jpeg(arr: np.ndarray, quality: int = 85, sampling: str = "420", **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", quality=quality,
                              subsampling={"444": 0, "422": 1, "420": 2}[sampling], **kw)
    return buf.getvalue()


def owned_rgba(data: bytes) -> np.ndarray:
    rgb = decode_baseline_jpeg(data)
    return np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], axis=-1)


# --------------------------------------------------------------------------- #
# decode_band
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("sampling", ["444", "422", "420"])
@pytest.mark.parametrize("size", [(64, 64), (45, 67), (17, 130)])
def test_decode_band_equals_jax_and_owned(sampling, size):
    data = jpeg(photo(*size, seed=sum(size)), 85, sampling)
    dec = DeviceJpegDecoder(data)
    assert dec.safe
    want = owned_rgba(data)
    np.testing.assert_array_equal(dec.decode_full(), want)
    np.testing.assert_array_equal(JaxDecoder(data).decode_band(0, size[0]), want)
    band = dec.decode_band(0, size[0], return_device=True)
    assert isinstance(band, torch.Tensor) and band.device.type == "cpu"
    np.testing.assert_array_equal(band.numpy(), want)


@pytest.mark.parametrize("band_h", [1, 3, 8, 16, 40])
def test_band_split_invariance(band_h):
    """Splits mid-MCU, where h2v2's vertical filter needs the row across
    the band edge, give the whole-image decode."""
    data = jpeg(photo(45, 67, seed=9), 85, "420")
    dec = DeviceJpegDecoder(data)
    parts = [dec.decode_band(y0, min(dec.height, y0 + band_h))
             for y0 in range(0, dec.height, band_h)]
    np.testing.assert_array_equal(np.concatenate(parts, axis=0), owned_rgba(data))


def test_band_into_a_wider_tensor_at_an_offset():
    data = jpeg(photo(40, 56, seed=2), 85, "420")
    dec = DeviceJpegDecoder(data)
    out = torch.zeros((16, 80, 4), dtype=torch.uint8)
    assert dec.decode_band(8, 24, return_device=True, out=out, x0=13) is out
    np.testing.assert_array_equal(out[:, 13:69].numpy(), owned_rgba(data)[8:24])
    assert not out[:, :13].any() and not out[:, 69:].any()


def test_gray_and_quality_extremes():
    g = np.random.default_rng(11).integers(0, 256, (33, 29), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(g, mode="L").save(buf, "JPEG", quality=92)
    data = buf.getvalue()
    dec = DeviceJpegDecoder(data)
    assert dec.safe and len(dec._zz_blocks) == 1
    np.testing.assert_array_equal(dec.decode_full(7), owned_rgba(data))
    np.testing.assert_array_equal(dec.decode_full(7), JaxDecoder(data).decode_full(7))
    for q in (30, 97):
        data = jpeg(photo(24, 40, seed=q), q, "444")
        np.testing.assert_array_equal(DeviceJpegDecoder(data).decode_full(16), owned_rgba(data))


def test_progressive_stream():
    data = jpeg(photo(40, 56, seed=3), 85, "420", progressive=True)
    dec = DeviceJpegDecoder(data)
    assert not dec.native_prefix  # the natural route: int32 scans and the NumPy prefix
    np.testing.assert_array_equal(dec.decode_full(16), owned_rgba(data))
    np.testing.assert_array_equal(dec.decode_full(16), JaxDecoder(data).decode_full(16))


def test_zigzag_prefix_truncation():
    """Smooth content uploads fewer than 64 coefficients a block, the same
    K as the JAX package's, and still decodes exactly."""
    arr = np.empty((64, 64, 3), np.uint8)
    arr[:] = np.linspace(40, 200, 64, dtype=np.float32)[None, :, None].astype(np.uint8)
    data = jpeg(arr, 85, "420")
    dec = DeviceJpegDecoder(data)
    assert max(dec._k) < 64 and dec._k == JaxDecoder(data)._k
    assert all(z.shape[1] == k for z, k in zip(dec._zz_blocks, dec._k))
    np.testing.assert_array_equal(dec.decode_full(), owned_rgba(data))


# --------------------------------------------------------------------------- #
# decode_tiles_band: a band of several tiles at once
# --------------------------------------------------------------------------- #


def tile_row() -> list[bytes]:
    """Four tiles 48 rows high that differ in sampling, quality (so in
    quantizer tables) and content (so in K): noise, a smooth ramp, gray."""
    rng = np.random.default_rng(21)
    ramp = np.tile(np.linspace(30, 220, 40, dtype=np.float32)[None, :, None],
                   (48, 1, 3)).astype(np.uint8)
    gray = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (48, 21), dtype=np.uint8), mode="L").save(
        gray, "JPEG", quality=80)
    return [jpeg(photo(48, 56, seed=1), 88, "420"), jpeg(photo(48, 33, seed=2), 60, "444"),
            jpeg(ramp, 95, "420"), gray.getvalue(), jpeg(photo(48, 30, seed=3), 30, "422")]


@pytest.mark.parametrize("band_h", [16, 5, 48])
def test_band_of_tiles_equals_per_tile_decode(band_h):
    """decode_tiles_band over a row of tiles with different K, quantizer
    tables and samplings, bands in a row through a ring of two staging
    buffers: each tile's columns equal its own decode_band and the owned
    host decoder; what lies between the tiles is not touched."""
    datas = tile_row()
    decs = [DeviceJpegDecoder(d) for d in datas]
    assert len({tuple(d._k) for d in decs}) > 2
    assert len({q.tobytes() for d in decs for q in d._qtabs_zz}) > 4
    x0s, at = [], 3
    for d in decs:
        x0s.append(at)
        at += d.width + 2
    ring = device_decoder.BandStaging("cpu")
    whole = [owned_rgba(d) for d in datas]
    for y0 in range(0, 48, band_h):
        y1 = min(48, y0 + band_h)
        out = torch.full((y1 - y0, at, 4), 5, dtype=torch.uint8)
        got = device_decoder.decode_tiles_band(
            [(d, y0, y1, x0) for d, x0 in zip(decs, x0s)], out, ring)
        assert got is out
        covered = np.zeros(at, bool)
        for d, x0, want in zip(decs, x0s, whole):
            np.testing.assert_array_equal(out[:, x0 : x0 + d.width].numpy(), want[y0:y1])
            np.testing.assert_array_equal(out[:, x0 : x0 + d.width].numpy(),
                                          d.decode_band(y0, y1))
            covered[x0 : x0 + d.width] = True
        assert (out[:, ~covered] == 5).all()


def test_staged_band_holds_each_quantizer_table_once():
    """The staged band of two copies of one tile beside another: the jobs
    share quantizer tables, every part starts at a 16 B boundary, and the
    flags say which column pass each job may take."""
    datas = tile_row()
    decs = [DeviceJpegDecoder(datas[0]), DeviceJpegDecoder(datas[0]), DeviceJpegDecoder(datas[1])]
    out = torch.zeros((16, 200, 4), dtype=torch.uint8)
    band = device_decoder.stage_tiles_band(
        [(d, 0, 16, x0) for d, x0 in zip(decs, (0, 56, 112))], out,
        device_decoder.BandStaging("cpu"))
    from image_stitch_tpu_torch.ops.kernels import idct_cta_table

    assert band.ctas.source is band.jobs and band.tile_rows.source is band.tiles
    assert band.jobs.shape == (9, 8) and band.tiles.shape == (3, 32)
    assert band.qtabs.shape == (4, 64)  # luma and chroma of each distinct tile
    assert band.jobs[:, 3].tolist() == [0, 1, 1, 0, 1, 1, 2, 3, 3]
    assert (band.jobs[:, 0] % 8 == 0).all() and (band.jobs[:, 5] % 16 == 0).all()
    assert band.jobs[:, 6].tolist() == [1] * 9  # photo content: the 32-bit column pass
    # What the kernels read is where the upload put it: the CTA rows made
    # from the job table, and the tile table itself.
    assert torch.equal(band.ctas.device, idct_cta_table(band.jobs))
    assert torch.equal(band.tile_rows.device, band.tiles)
    assert band.ctas.device.data_ptr() % 16 == band.tile_rows.device.data_ptr() % 16 == 0
    assert band.plane_bytes == int((band.jobs[:, 1] * 64).sum())


def test_staging_ring_and_band_checks():
    ring = device_decoder.BandStaging("cpu")
    slots = [ring.acquire(100)[0] for _ in range(4)]
    assert slots == [0, 1, 0, 1] and ring.waits == 0  # nothing to wait for on the CPU
    assert ring.acquire(10)[1].numel() >= 100  # a buffer is kept, not shrunk
    dec = DeviceJpegDecoder(tile_row()[0])
    with pytest.raises(image_stitch_tpu_torch.StitchError):  # 8 rows into a band of 16
        device_decoder.decode_tiles_band([(dec, 0, 8, 0)], torch.zeros((16, 56, 4),
                                         dtype=torch.uint8), ring)
    with pytest.raises(image_stitch_tpu_torch.StitchError):  # a band on another device
        device_decoder.decode_tiles_band([(dec, 0, 16, 0)], torch.zeros(
            (16, 56, 4), dtype=torch.uint8, device="meta"), ring)


def test_hostile_coefficients_take_the_64_bit_column_pass():
    """|coef * q| past the 32-bit column pass's bound: the job's flag is
    off, and the band still equals the owned decoder."""
    from image_stitch_tpu_torch.ops.kernels import IDCT_INT32_MAX_DEQ

    dc = [min(i, 6) * 2000 for i in range(16)]
    data = gray_jpeg(dc, np.full(64, 255, np.int64), rows=2)
    dec = DeviceJpegDecoder(data)
    assert max(dc) * 255 > IDCT_INT32_MAX_DEQ and dec._narrow == [False]
    out = torch.zeros((16, 64, 4), dtype=torch.uint8)
    band = device_decoder.stage_tiles_band([(dec, 0, 16, 0)], out,
                                           device_decoder.BandStaging("cpu"))
    assert band.jobs[:, 6].tolist() == [0]
    np.testing.assert_array_equal(dec.decode_full(), owned_rgba(data))


# --------------------------------------------------------------------------- #
# The grid path
# --------------------------------------------------------------------------- #


def jpeg_tile(seed: int, w: int, h: int, sampling: str = "420") -> bytes:
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 255, w, dtype=np.float32)
    arr = np.empty((h, w, 3), np.uint8)
    arr[..., 0] = x[None, :].astype(np.uint8)
    arr[..., 1] = rng.integers(0, 256, (h, w), dtype=np.uint8)
    arr[..., 2] = x[None, ::-1].astype(np.uint8)
    return jpeg(arr, 88, sampling)


def png_tile(seed: int, w: int, h: int) -> bytes:
    arr = np.random.default_rng(seed).integers(0, 256, (h, w, 4), dtype=np.uint8)
    arr[..., 3] = 255
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    return buf.getvalue()


def options(inputs, **kw) -> dict:
    return {"inputs": inputs, "layout": {"columns": kw.pop("columns", 2)},
            "outputFormat": "jpeg", "jpegQuality": 85, "bandHeight": kw.pop("band_height", 32),
            **kw}


def port(opts) -> bytes:
    return image_stitch_tpu_torch.concat_to_buffer(opts, device="cpu")


def jax_package(opts, backend: str) -> bytes:
    return image_stitch_tpu.concat_to_buffer({**opts, "backend": backend})


@pytest.fixture
def decodes(monkeypatch):
    """The device tier's decodes, one entry per tile and band: (y0, y1, into
    a band tensor). A band decoded whole by ``decode_tiles_band`` gives an
    entry per tile, into the band; ``decode_band`` (itself a band of one
    tile) gives one entry, into a band only when it was handed one."""
    calls, inside = [], []
    real_band, real_tiles = DeviceJpegDecoder.decode_band, device_decoder.decode_tiles_band

    def counted_band(self, y0, y1, return_device=False, out=None, x0=0, **kw):
        calls.append((y0, y1, out is not None))
        inside.append(self)
        try:
            return real_band(self, y0, y1, return_device, out, x0, **kw)
        finally:
            inside.pop()

    def counted_tiles(items, out, staging):
        if not inside:
            calls.extend((y0, y1, True) for _dec, y0, y1, _x0 in items)
        return real_tiles(items, out, staging)

    monkeypatch.setattr(DeviceJpegDecoder, "decode_band", counted_band)
    monkeypatch.setattr(device_decoder, "decode_tiles_band", counted_tiles)
    return calls


@pytest.fixture
def host_decodes(monkeypatch):
    """Whole-tile decodes on the host tier."""
    from image_stitch_tpu_torch.codecs.jpeg import decoder

    calls = []
    real = decoder.decode_jpeg_to_rgba

    def counted(data, options=None):
        calls.append(len(data))
        return real(data, options)

    monkeypatch.setattr(decoder, "decode_jpeg_to_rgba", counted)
    return calls


@pytest.mark.parametrize("ri", [0, 1])
def test_grid_fast_path_matches_jax(decodes, host_decodes, ri):
    """Every band tiled by JPEG tiles is decoded into one band tensor on the
    device and encoded there; no tile is decoded on the host."""
    opts = options([jpeg_tile(s, 64, 64) for s in range(4)], jpegRestartIntervalRows=ri)
    got = port(opts)
    assert got == jax_package(opts, "numpy") == jax_package(opts, "jax")
    assert len(decodes) == 4 * 2 and all(into for _y0, _y1, into in decodes)
    assert not host_decodes
    counters = image_stitch_tpu_torch.EncodeCounters()
    assert image_stitch_tpu_torch.concat_to_buffer(opts, device="cpu", counters=counters) == got
    # 4 bands of 2 tiles: decoded whole, one launch pair a band.
    assert (counters.decode_tile_bands, counters.decode_bands_on_device) == (8, 4)


def test_grid_row_of_unlike_tiles_matches_jax(decodes, host_decodes):
    """Tile rows whose tiles differ in sampling, quality (quantizer tables)
    and content (K): one staged band carries them all; the JAX package's
    bytes."""
    ramp = np.tile(np.linspace(30, 220, 64, dtype=np.float32)[None, :, None],
                   (64, 1, 3)).astype(np.uint8)
    inputs = [jpeg(photo(64, 64, seed=1), 88, "420"), jpeg(photo(64, 64, seed=2), 60, "444"),
              jpeg(ramp, 95, "420"), jpeg(photo(64, 64, seed=3), 30, "422"),
              jpeg(ramp[::-1].copy(), 70, "444"), jpeg(photo(64, 64, seed=4), 97, "420")]
    assert len({tuple(DeviceJpegDecoder(d)._k) for d in inputs}) > 2
    opts = options(inputs, columns=3, band_height=16)
    assert port(opts) == jax_package(opts, "numpy")
    assert len(decodes) == 6 * 4 and all(into for _y0, _y1, into in decodes)
    assert not host_decodes


def test_band_crossing_tile_boundary(decodes, host_decodes):
    """Tiles 56 rows high in 16-row bands: a band that crosses a tile
    boundary is decoded on the device too, each row of tiles it crosses
    into its own rows of the band tensor; no band is assembled on the
    host."""
    opts = options([jpeg_tile(s, 48, 56, "444") for s in range(4)], band_height=16)
    counters = image_stitch_tpu_torch.EncodeCounters()
    got = image_stitch_tpu_torch.concat_to_buffer(opts, device="cpu", counters=counters)
    assert got == jax_package(opts, "numpy")
    assert {into for _y0, _y1, into in decodes} == {True} and not host_decodes
    # 7 bands of 2 tiles; band 3 (rows 48-64) crosses: rows 48-56 of the
    # top tiles, then rows 0-8 of the bottom ones.
    assert len(decodes) == 7 * 2 + 2 and decodes[6:10] == [(48, 56, True)] * 2 + [(0, 8, True)] * 2
    assert (counters.decode_bands_on_device, counters.decode_tile_bands) == (7, 16)
    assert counters.decode_staged_uploads == 8 and counters.decode_tiles_opened == 4


def test_mixed_png_jpeg_grid(decodes):
    inputs = [jpeg_tile(0, 64, 64), png_tile(1, 64, 64), jpeg_tile(2, 64, 64), png_tile(3, 64, 64)]
    opts = options(inputs)
    assert port(opts) == jax_package(opts, "numpy")
    assert decodes and not any(into for _y0, _y1, into in decodes)
    counters = image_stitch_tpu_torch.EncodeCounters()
    image_stitch_tpu_torch.concat_to_buffer(opts, device="cpu", counters=counters)
    # A PNG tile beside each JPEG tile: the host plan, the JPEG tiles one
    # decode_band a band (2 tiles of 2 bands), no band decoded whole.
    assert (counters.decode_tile_bands, counters.decode_bands_on_device) == (4, 0)


def test_duplicate_inputs(decodes):
    """One stream four times: the four grid cells may share one decoder,
    but the tier counts a tile opened per image index it serves, and every
    band is decoded whole on the device."""
    tile = jpeg_tile(7, 64, 64)
    opts = options([tile, tile, tile, tile])
    counters = image_stitch_tpu_torch.EncodeCounters()
    got = b"".join(image_stitch_tpu_torch.concat_streaming(opts, device="cpu",
                                                           counters=counters))
    assert got == jax_package(opts, "numpy")
    assert decodes and all(into for _y0, _y1, into in decodes)
    # 128 canvas rows in 32-row bands; each band's two tiles in one decode.
    assert counters.decode_tiles_opened == 4 and counters.decode_tiles_native_prefix == 4
    assert (counters.decode_bands_on_device, counters.decode_tile_bands) == (4, 8)


def test_off_switch(decodes, monkeypatch):
    monkeypatch.setenv("STITCH_TPU_DEVICE_DECODE", "0")
    opts = options([jpeg_tile(s, 64, 64) for s in range(2)])
    assert port(opts) == jax_package(opts, "numpy")
    assert not decodes


def test_background_holes(decodes):
    """A 2 x 2 grid with one cell empty: the second tile row's bands hold
    background, so they are assembled on the host, their tile still
    decoded by the device tier; the first row's bands stay on the
    device."""
    opts = options([jpeg_tile(s, 40, 40) for s in range(3)])
    assert port(opts) == jax_package(opts, "numpy")
    assert {into for _y0, _y1, into in decodes} == {True, False}


def test_420_output_and_png_output_unaffected(decodes):
    opts = options([jpeg_tile(s, 64, 48) for s in range(4)], jpegSampling="420",
                   jpegRestartIntervalRows=1)
    assert port(opts) == jax_package(opts, "numpy")
    assert decodes
    decodes.clear()
    png_opts = {**opts, "outputFormat": "png"}
    assert port(png_opts) == jax_package(png_opts, "numpy")
    assert not decodes


def test_stream_bands_reads_device_bands_back():
    opts = options([jpeg_tile(s, 64, 64) for s in range(4)])
    bands = list(image_stitch_tpu_torch.TorchStreamingConcatenator(opts, device="cpu")
                 .stream_bands())
    assert all(type(b) is np.ndarray for b in bands)
    from image_stitch_tpu.core import CoreStreamingConcatenator

    ref = list(CoreStreamingConcatenator({**opts, "backend": "numpy"}).stream_bands())
    for a, b in zip(bands, ref, strict=True):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------- #
# The JAX package's packed handoff
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("ri", [0, 1])
def test_decode_packed_variable_changes_nothing(decodes, monkeypatch, ri):
    """With STITCH_TPU_DECODE_PACKED=1 the JAX package hands its bands over
    packed; the port reads no such variable (``decodes`` would refuse a
    ``packed=`` argument): the same device decodes, into band tensors, and
    the JAX package's packed bytes."""
    opts = options([jpeg_tile(s, 64, 64) for s in range(4)], jpegRestartIntervalRows=ri)
    plain = port(opts)
    calls = list(decodes)
    decodes.clear()
    monkeypatch.setenv("STITCH_TPU_DECODE_PACKED", "1")
    assert port(opts) == plain == jax_package(opts, "jax") == jax_package(opts, "numpy")
    assert decodes == calls and len(calls) == 4 * 2 and all(into for *_, into in calls)


def test_decode_packed_mixed_plan_stream(decodes, monkeypatch):
    """Tiles 56 rows high in 16-row bands: the JAX package packs the bands
    it decodes whole and interleaves those assembled on the host; the port,
    which decodes the bands that cross a tile boundary on the device too,
    gives its bytes."""
    monkeypatch.setenv("STITCH_TPU_DECODE_PACKED", "1")
    opts = options([jpeg_tile(s, 48, 56) for s in range(4)], band_height=16)
    assert port(opts) == jax_package(opts, "jax") == jax_package(opts, "numpy")
    assert {into for *_, into in decodes} == {True}


@pytest.mark.parametrize("gray", [False, True])
def test_jax_packed_decode_band_into_the_port_encoder(gray):
    """The JAX package's ``decode_band(packed=True)`` on a device return is
    the little-endian pack of the RGBA that the port's ``decode_band``
    gives; the port's encoders take that packed band as its RGBA: the
    same bytes."""
    rng = np.random.default_rng(22)
    if gray:
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (40, 56), dtype=np.uint8), mode="L").save(
            buf, "JPEG", quality=85)
        data = buf.getvalue()
    else:
        data = jpeg(rng.integers(0, 256, (40, 56, 3), dtype=np.uint8), 85, "420")
    rgba = DeviceJpegDecoder(data).decode_band(0, 40)
    packed = np.asarray(JaxDecoder(data).decode_band(0, 40, return_device=True, packed=True))
    assert packed.dtype == np.uint32 and packed.shape == (40, 56)
    np.testing.assert_array_equal(packed.view(np.uint8).reshape(40, 56, 4), rgba)

    def encoded(band, tensor):
        enc = TorchStreamingJpegEncoder(56, 40, 85, device="cpu", restart_interval_rows=1)
        band = torch.from_numpy(band.copy()) if tensor else band
        return b"".join(enc.encode_band(band)) + b"".join(enc.finish())

    for tensor in (False, True):
        assert encoded(packed, tensor) == encoded(rgba, tensor)


# --------------------------------------------------------------------------- #
# The encoder's tensor bands
# --------------------------------------------------------------------------- #


def encode(bands, **kw) -> bytes:
    enc = TorchStreamingJpegEncoder(width=kw.pop("width", 45), height=kw.pop("height"),
                                    device="cpu", **kw)
    out = b"".join(enc.header())
    for band in bands:
        out += b"".join(enc.encode_band(band))
    return out + b"".join(enc.finish())


@pytest.mark.parametrize("sampling,ri", [("444", 0), ("444", 2), ("420", 1)])
def test_encoder_tensor_bands_equal_host_bands(sampling, ri):
    """Bands of 13 rows (pending rows held back across bands, a partial
    final strip) and an odd width (edge padding): tensors alone, and
    tensors alternating with host arrays, give the host bands' bytes."""
    rng = np.random.default_rng(3)
    img = np.concatenate([photo(61, 45, seed=4), np.full((61, 45, 1), 255, np.uint8)], -1)
    img[..., :3] = np.clip(img[..., :3] + rng.integers(-3, 4, img[..., :3].shape), 0, 255)
    host = [img[y : y + 13] for y in range(0, 61, 13)]
    kw = {"height": 61, "sampling": sampling, "restart_interval_rows": ri}
    want = encode(host, **kw)
    assert encode([torch.from_numpy(b.copy()) for b in host], **kw) == want
    mixed = [torch.from_numpy(b.copy()) if i % 2 else b for i, b in enumerate(host)]
    assert encode(mixed, **kw) == want
    mixed = [b if i % 2 else torch.from_numpy(b.copy()) for i, b in enumerate(host)]
    assert encode(mixed, **kw) == want


def test_encoder_rejects_a_tensor_on_another_device():
    enc = TorchStreamingJpegEncoder(width=16, height=16, device="cpu")
    with pytest.raises(ValueError):
        b"".join(enc.encode_band(torch.zeros((16, 16, 4), dtype=torch.uint8, device="meta")))


# --------------------------------------------------------------------------- #
# Streams past the device tier's bounds
# --------------------------------------------------------------------------- #


def gray_jpeg(dc: list[int], q: np.ndarray, rows: int = 1) -> bytes:
    """A baseline gray JPEG of 8 * rows x 8 * len(dc) // rows px whose
    blocks have the given DC values (natural-order quantized), some AC
    terms, and the natural-order table q: DC differences of up to 2047 a
    block accumulate to any value."""
    n = len(dc)
    blocks = np.zeros((n, 64), np.int64)
    blocks[:, 0] = dc
    blocks[:, 1] = np.arange(n) % 7 - 3
    blocks[:, 9] = 5
    dc_codes = T.build_huffman_codes(T.STD_DC_LUMA_BITS, T.STD_DC_LUMA_VALS)
    ac_codes = T.build_huffman_codes(T.STD_AC_LUMA_BITS, T.STD_AC_LUMA_VALS)
    codes, lens, _ = HuffmanEncoder(dc_codes, ac_codes).encode_component_blocks(blocks, 0)
    packer = BitPacker()
    scan = packer.pack(np.concatenate(codes), np.concatenate(lens)) + packer.flush()
    h, w = 8 * rows, 8 * n // rows
    out = bytearray(b"\xff\xd8")
    out += b"\xff\xdb" + (67).to_bytes(2, "big") + bytes([0])
    out += bytes(int(v) for v in q[T.ZIGZAG])
    out += b"\xff\xc0" + (11).to_bytes(2, "big") + bytes([8]) + h.to_bytes(2, "big")
    out += w.to_bytes(2, "big") + bytes([1, 1, 0x11, 0])
    for tc_th, bits, vals in ((0x00, T.STD_DC_LUMA_BITS, T.STD_DC_LUMA_VALS),
                              (0x10, T.STD_AC_LUMA_BITS, T.STD_AC_LUMA_VALS)):
        payload = bytes([tc_th]) + bytes(bits[1:17]) + bytes(vals)
        out += b"\xff\xc4" + (2 + len(payload)).to_bytes(2, "big") + payload
    out += b"\xff\xda" + (8).to_bytes(2, "big") + bytes([1, 1, 0x00, 0, 63, 0])
    return bytes(out + scan + b"\xff\xd9")


def test_dc_accumulation_past_int16_takes_the_host_tier(decodes):
    """DC climbs by 2047 a block to 34,799: not int16, so ``safe`` is False
    in both packages and the tile is decoded on the host tier; the bytes
    equal the JAX package's."""
    dc = [min(i, 17) * 2047 for i in range(24)]
    data = gray_jpeg(dc, np.ones(64, np.int64))
    assert max(dc) >= 1 << 15
    assert not DeviceJpegDecoder(data).safe and not JaxDecoder(data).safe
    opts = options([data, data], band_height=8)
    assert port(opts) == jax_package(opts, "numpy")
    assert not decodes


def test_past_m_safe_decodes_on_the_device_tier(decodes):
    """|coef * q| = 12,000 * 255 > M_SAFE, |coef| < 2^15: the JAX package
    decodes it on its host tier, the port on its device tier; with the
    owned host decoder on both sides the bytes are equal, and the port's
    device decode equals the owned decoder."""
    from image_stitch_tpu.ops.jpeg_idct_device import M_SAFE

    dc = [min(i, 6) * 2000 for i in range(16)]
    q = np.full(64, 255, np.int64)
    data = gray_jpeg(dc, q, rows=2)
    assert max(dc) * 255 > M_SAFE and max(dc) < 1 << 15
    assert DeviceJpegDecoder(data).safe and not JaxDecoder(data).safe
    np.testing.assert_array_equal(DeviceJpegDecoder(data).decode_full(), owned_rgba(data))
    decodes.clear()
    opts = options([data, data], band_height=8, decoderOptions={"force_owned": True})
    assert port(opts) == jax_package(opts, "numpy")
    assert decodes and all(into for _y0, _y1, into in decodes)


def test_marker_scan_matches_the_jax_package():
    """The port's marker scan (bytes.find) against the JAX package's byte
    loop: random entropy-like bytes with stuffed 0xFF00, RST markers, fill
    bytes and real markers, from every start."""
    from image_stitch_tpu.codecs.jpeg.owned_decoder import _next_marker_pos as ref
    from image_stitch_tpu_torch.codecs.jpeg.owned_decoder import _next_marker_pos

    rng = np.random.default_rng(12)
    for trial in range(40):
        data = bytearray(rng.integers(0, 255, 300, dtype=np.uint8).tobytes())
        for pos in rng.integers(0, 299, 12):
            data[pos : pos + 2] = bytes([0xFF, int(rng.choice([0x00, 0xD3, 0xD9, 0xFF, 0xC4]))])
        if trial % 3 == 0:
            data[-1] = 0xFF
        data = bytes(data)
        for start in range(0, len(data), 7):
            assert _next_marker_pos(data, start) == ref(data, start)


# --------------------------------------------------------------------------- #
# The transport straight from the native scan, against the natural route
# --------------------------------------------------------------------------- #


def one_scan_a_component(w: int = 37, h: int = 20) -> bytes:
    """A baseline 4:2:0 JPEG of w x h px written as three scans of one
    component each (T.81 A.2's non-interleaved scans): the luma scan walks
    its 5 x 3 true blocks, not the 6 x 4 of its MCUs, so the MCU padding is
    never coded."""
    rng = np.random.default_rng(5)
    dc_codes = T.build_huffman_codes(T.STD_DC_LUMA_BITS, T.STD_DC_LUMA_VALS)
    ac_codes = T.build_huffman_codes(T.STD_AC_LUMA_BITS, T.STD_AC_LUMA_VALS)
    out = bytearray(b"\xff\xd8")
    out += b"\xff\xdb" + (67).to_bytes(2, "big") + bytes([0]) + bytes([4] * 64)
    out += b"\xff\xc0" + (17).to_bytes(2, "big") + bytes([8]) + h.to_bytes(2, "big")
    out += w.to_bytes(2, "big") + bytes([3, 1, 0x22, 0, 2, 0x11, 0, 3, 0x11, 0])
    for tc_th, bits, vals in ((0x00, T.STD_DC_LUMA_BITS, T.STD_DC_LUMA_VALS),
                              (0x10, T.STD_AC_LUMA_BITS, T.STD_AC_LUMA_VALS)):
        payload = bytes([tc_th]) + bytes(bits[1:17]) + bytes(vals)
        out += b"\xff\xc4" + (2 + len(payload)).to_bytes(2, "big") + payload
    for cid, scale in ((1, 8), (2, 16), (3, 16)):
        n = -(-w // scale) * -(-h // scale)
        blocks = np.zeros((n, 64), np.int64)
        blocks[:, 0] = rng.integers(-60, 60, n)
        blocks[:, 1:10] = rng.integers(-6, 7, (n, 9)) * (rng.random((n, 9)) < 0.5)
        codes, lens, _ = HuffmanEncoder(dc_codes, ac_codes).encode_component_blocks(blocks, 0)
        packer = BitPacker()
        scan = packer.pack(np.concatenate(codes), np.concatenate(lens)) + packer.flush()
        out += b"\xff\xda" + (8).to_bytes(2, "big") + bytes([1, cid, 0x00, 0, 63, 0]) + scan
    return bytes(out + b"\xff\xd9")


def route_stream(name: str) -> bytes:
    """The streams both routes are held to, by name."""
    rng = np.random.default_rng(41)
    if name == "420_camera":
        return jpeg(photo(48, 72, seed=31), 90, "420")
    if name == "444":
        return jpeg(photo(40, 56, seed=32), 85, "444")
    if name == "gray":
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (33, 29), dtype=np.uint8), mode="L").save(
            buf, "JPEG", quality=92)
        return buf.getvalue()
    if name == "restarts":
        return jpeg(photo(45, 67, seed=33), 90, "420", restart_marker_blocks=3)
    if name == "one_scan_a_component":
        return one_scan_a_component()
    if name == "smooth":
        ramp = np.linspace(40, 200, 64, dtype=np.float32)[None, :, None].astype(np.uint8)
        return jpeg(np.broadcast_to(ramp, (64, 64, 3)).copy(), 85, "420")
    if name == "noise_q97":
        return jpeg(rng.integers(0, 256, (32, 40, 3), dtype=np.uint8), 97, "444")
    if name == "fill_bytes":  # fill bytes before EOI (T.81 B.1.1.2)
        return jpeg(photo(32, 48, seed=34), 90, "420")[:-2] + b"\xff\xff\xff\xd9"
    if name == "trailing_rst":  # an RSTn after the last interval, which readers skip
        return route_stream("restarts")[:-2] + b"\xff\xd7\xff\xd9"
    if name == "marker_in_interval":  # a stray marker the restart resync skips
        data = bytearray(route_stream("restarts"))
        at = data.index(b"\xff\xd0") // 2 + data.index(b"\xff\xda") // 2
        at += data[at - 1] == 0xFF
        data[at : at + 2] = b"\xff\xcb"
        return bytes(data)
    if name in ("flat", "flat_level"):  # AC all zero; at 128, DC zero too
        return jpeg(np.full((24, 40, 3), 200 if name == "flat" else 128, np.uint8), 85, "444")
    assert name == "dc_past_int16"
    return gray_jpeg([min(i, 17) * 2047 for i in range(24)], np.ones(64, np.int64))


ROUTE_STREAMS = ["420_camera", "444", "gray", "restarts", "one_scan_a_component", "smooth",
                 "noise_q97", "flat", "flat_level", "fill_bytes", "dc_past_int16"]


class ZeroedStaging(device_decoder.BandStaging):
    """A staging ring that zeroes each slot it hands out (so the padding
    between parts compares) and keeps the bytes of its last upload."""

    def acquire(self, nbytes):
        slot, buf = super().acquire(nbytes)
        buf.zero_()
        return slot, buf

    def upload(self, slot, nbytes):
        dev = super().upload(slot, nbytes)
        self.sent = dev.clone()
        return dev


@pytest.mark.parametrize("name", ROUTE_STREAMS)
def test_native_prefix_equals_the_natural_route(name, monkeypatch):
    """The transport the native scan writes (int16 zigzag blocks in pooled
    scratch that holds garbage, its K, narrow flags and safe) against the
    natural route (the int32 scan and the NumPy prefix): the same held
    blocks, and the same bytes staged for a band of the whole image. The
    host tier's coefficients still equal the JAX package's."""
    from image_stitch_tpu.codecs.jpeg.owned_decoder import decode_coefficients as jax_coefs
    from image_stitch_tpu_torch import native
    from image_stitch_tpu_torch.codecs.jpeg.owned_decoder import (
        decode_coefficients,
        decode_zigzag_coefficients,
    )

    data = route_stream(name)
    monkeypatch.setattr(native.buffer_pool, "get", lambda size: np.full(size, 0x5A, np.uint8))
    new = DeviceJpegDecoder(data)
    monkeypatch.setattr(device_decoder, "decode_zigzag_coefficients", lambda data: None)
    old = DeviceJpegDecoder(data)
    # A value past int16 sends the stream back to the natural route.
    assert new.native_prefix == (name != "dc_past_int16") and not old.native_prefix
    assert (new._k, new._narrow, new.safe) == (old._k, old._narrow, old.safe)
    assert len(new._zz_blocks) == len(old._zz_blocks) == (1 if name in ("gray", "dc_past_int16")
                                                          else 3)
    for a, b in zip(new._zz_blocks, old._zz_blocks):
        assert a.dtype == b.dtype == np.int16 and a.flags.c_contiguous
        np.testing.assert_array_equal(a, b)
    expect_k = {"smooth": lambda k: max(k) < 64, "noise_q97": lambda k: max(k) == 64,
                "flat": lambda k: k == [8, 8, 8], "flat_level": lambda k: k == [8, 8, 8]}
    assert expect_k.get(name, lambda k: True)(new._k), new._k
    assert new.safe == (name != "dc_past_int16")
    staged = []
    out = torch.zeros((new.height, new.width, 4), dtype=torch.uint8)
    for dec in (new, old):
        ring = ZeroedStaging("cpu")
        band = device_decoder.stage_tiles_band([(dec, 0, dec.height, 0)], out, ring)
        staged.append((band.staged_bytes, ring.sent.numpy().tobytes()))
    assert staged[0] == staged[1]
    natural = decode_coefficients(data)[0]
    for a, b in zip(natural, jax_coefs(data)[0]):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    zz = decode_zigzag_coefficients(data)
    if zz is not None:  # the scan's figures, as a NumPy pass reads them
        assert list(zip(zz.last, zz.peak)) == [device_decoder._natural_figures(b)
                                               for b in natural]
        zz.release()
    if new.safe:
        np.testing.assert_array_equal(new.decode_full(16), owned_rgba(data))


def test_the_grid_counts_its_native_prefix_tiles():
    """A grid of JPEG tiles through ``concat_streaming(device="cpu")``: every
    tile the device tier opens takes the native scan's transport; a
    progressive tile among them takes the natural route, and the output is
    the same bytes as the JAX package's."""
    tiles = [jpeg_tile(s, 40, 24) for s in range(4)]
    counters = image_stitch_tpu_torch.EncodeCounters()
    b"".join(image_stitch_tpu_torch.concat_streaming(options(tiles), device="cpu",
                                                    counters=counters))
    assert counters.decode_tiles_opened == 4 and counters.decode_tiles_native_prefix == 4
    tiles[1] = jpeg(photo(24, 40, seed=8), 88, "420", progressive=True)
    counters = image_stitch_tpu_torch.EncodeCounters()
    out = b"".join(image_stitch_tpu_torch.concat_streaming(options(tiles), device="cpu",
                                                          counters=counters))
    assert counters.decode_tiles_opened == 4 and counters.decode_tiles_native_prefix == 3
    assert out == jax_package(options(tiles), "numpy")


@pytest.mark.parametrize("name", ["420_camera", "restarts", "one_scan_a_component",
                                  "fill_bytes", "trailing_rst", "marker_in_interval"])
def test_the_native_scan_finds_the_marker_after_it(name, monkeypatch):
    """The zigzag scan gives the marker walk the position of the next
    marker that is not RSTn, where the natural route searches the scan's
    bytes for it: the same position after every scan, also where a stray
    marker lies inside a restart interval (the reader's resync skips it, so
    the search cannot start where the reader stopped)."""
    from image_stitch_tpu_torch.codecs.jpeg import owned_decoder as O

    real, ends = O._decode_scan_zigzag_native, []

    def checked(data, scan_start, *args):
        end = real(data, scan_start, *args)
        ends.append((end, O._next_marker_pos(data, scan_start)))
        return end

    monkeypatch.setattr(O, "_decode_scan_zigzag_native", checked)
    data = route_stream(name)
    if name == "marker_in_interval":  # the walk stops at that marker, on both routes
        for decode in (O.decode_zigzag_coefficients, O.decode_coefficients):
            with pytest.raises(image_stitch_tpu_torch.StitchError, match="0xFFCB"):
                decode(data)
    else:
        O.decode_zigzag_coefficients(data).release()
    assert len(ends) == (3 if name == "one_scan_a_component" else 1)
    assert all(got == want for got, want in ends), ends
    if name in ("fill_bytes", "trailing_rst"):
        assert ends[0][0] == len(data) - (4 if name == "fill_bytes" else 2)
    if name == "marker_in_interval":
        assert ends[0][0] == data.index(b"\xff\xcb") < data.rindex(b"\xff\xd0")
