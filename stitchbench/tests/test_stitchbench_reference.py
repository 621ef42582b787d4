"""The plain reference held, at tiny sizes, to the port's device="cpu"
output and to zlib: JPEG byte for byte (4:4:4 and 4:2:0, several
qualities, sizes off the MCU grid), PNG row for row, and the checks built
on them."""

from __future__ import annotations

import zlib

import numpy as np
import pytest

from conftest import SEED, tiny_cell


def image(h, w, seed=0):
    rng = np.random.default_rng(seed)
    img = np.clip(rng.normal(128, 50, (h, w, 4)), 0, 255).astype(np.uint8)
    img[: h // 2, : w // 3] = 0
    img[0, 0, :3] = (0, 0, 255)           # saturated blue: Cb reaches 256
    return img


@pytest.mark.parametrize("h,w", [(8, 8), (24, 40), (37, 53), (64, 48)])
@pytest.mark.parametrize("quality", [20, 85, 100])
def test_jpeg_444_equals_the_port(h, w, quality):
    import image_stitch_tpu_torch as port

    from stitchbench.reference import jpeg as ref

    img = image(h, w, quality)
    assert ref.encode(img, quality) == port.encode_jpeg(img, w, h, quality, device="cpu")


@pytest.mark.parametrize("h,w", [(16, 16), (37, 53)])
def test_jpeg_420_equals_the_port(h, w):
    import image_stitch_tpu_torch as port

    from stitchbench.reference import jpeg as ref

    img = image(h, w, 7)
    assert ref.encode(img, 90, "420") == port.encode_jpeg(img, w, h, 90, sampling="420",
                                                          device="cpu")


def test_jpeg_in_parallel_ranges_equals_one_pass(pool):
    """Row ranges coded apart (with the DC predictors of the MCU row above)
    and joined give the one-pass stream."""
    from stitchbench.reference import jpeg as ref

    img = ref.pad_to(image(72, 40, 3)[..., :3], 8, 8)
    whole = ref.encode_rows(img, 85, "444")
    parts = [ref.encode_rows(img[r: r + 24], 85, "444",
                             ref.last_dcs(img[:r] if r else None, 85, "444"))
             for r in range(0, 72, 24)]
    joined = ref.join_bits(parts)
    assert joined[1] == whole[1] and np.array_equal(joined[0], whole[0])


def test_float32_dct_is_not_the_exact_one():
    from stitchbench.reference import jpeg as ref

    blocks = image(64, 64, 5)[..., 0].astype(np.int64).reshape(8, 8, 8, 8).transpose(0, 2, 1, 3)
    blocks = blocks.reshape(-1, 8, 8) - 128
    exact, approx = ref.fdct(blocks), ref.fdct(blocks, "float32")
    assert np.abs(exact - approx).max() <= 8 and (exact != approx).any()


def test_png_filter_choice_equals_the_port():
    import image_stitch_tpu_torch as port

    from stitchbench.reference import png as ref

    img = image(30, 21, 9)
    img[5] = img[4]                               # a row where Up wins
    img[9, :, :] = 7                              # a flat row
    data = port.concat_arrays([img], {"columns": 1}, output="png", device="cpu")
    idat = b"".join(d for k, d, _ in ref.chunks(data) if k == b"IDAT")
    got = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(30, 1 + 21 * 4)
    assert np.array_equal(got, ref.filter_image(img))
    assert len(set(got[:, 0].tolist())) > 1


def test_png_reader_round_trip():
    from stitchbench.reference import png as ref

    img = image(12, 9, 2)
    assert np.array_equal(ref.decode(ref.encode(img, 6)), img)


def port_output(cell, pool, j=3):
    import image_stitch_tpu_torch as port

    tiles = cell.traffic.make_state(SEED, pool)
    job = cell.traffic.job(SEED, tiles, j)
    return b"".join(port.concat_streaming(dict(cell.options, **job.options), device="cpu")), \
        job.spec


@pytest.mark.parametrize("name", ["jpeg_q85.mosaic_10k", "png_l6.mosaic_10k"])
def test_checks_pass_the_port_and_fail_each_control(name, pool):
    """The check of a job's output holds on the port's own output, and
    fails when a control stands in for it: the float32 DCT (JPEG); deflate
    at level 1, or Paeth on every row (PNG). Tiles of 200 x 160: on a few
    KB, zlib's levels 1 and 6 lie closer than the PNG size's limit."""
    from stitchbench.control import CONTROLS, control_numbers
    from stitchbench.reference import check as ref

    cell = tiny_cell(name, 200, 160)
    out, spec = port_output(cell, pool)
    nums = ref.check(spec, cell.options, out, pool)
    assert all(c["holds"] for c in ref.limits_hold(nums).values()), nums
    for control in CONTROLS[cell.options["outputFormat"]]:
        numbers = control_numbers(cell, SEED, pool, control)
        assert not all(c["holds"] for c in ref.limits_hold(numbers).values()), (control, numbers)
        if control == "level1":
            assert numbers["png_rows_differing"] == numbers["png_format_errors"] == 0
            assert numbers["png_idat_excess_pct"] > ref.LIMITS["png_idat_excess_pct"][1]
        if control == "paeth":
            assert numbers["png_format_errors"] == 0 and numbers["png_rows_differing"] > 0


def test_png_size_reads_the_level(pool):
    """The port's IDAT at level 6 reads within the limit of zlib's; the same
    rows re-deflated at level 1, or stored, read above it."""
    from stitchbench.reference import check as ref
    from stitchbench.reference import png as ref_png

    cell = tiny_cell("png_l6.mosaic_10k", 200, 160)
    out, spec = port_output(cell, pool, j=1)
    expected = ref.expected_png(spec, pool, 6)
    assert ref.check_png(out, spec.canvas, expected)["png_idat_excess_pct"] \
        < ref.LIMITS["png_idat_excess_pct"][1]
    raw = zlib.decompress(b"".join(d for k, d, _ in ref_png.chunks(out) if k == b"IDAT"))
    h, w = spec.canvas
    for level in (1, 0):
        again = (ref_png.SIGNATURE + ref_png.ihdr(w, h)
                 + ref_png.chunk(b"IDAT", zlib.compress(raw, level)) + ref_png.chunk(b"IEND", b""))
        nums = ref.check_png(again, spec.canvas, expected)
        assert nums["png_rows_differing"] == 0 == nums["png_format_errors"]
        assert nums["png_idat_excess_pct"] > ref.LIMITS["png_idat_excess_pct"][1]


def test_numbers_of_several_jobs_combine():
    from stitchbench.reference.check import combine

    totals = combine({"jobs_checked": 2}, {"png_rows_differing": 3, "png_idat_excess_pct": 0.5})
    combine(totals, {"png_rows_differing": 1, "png_idat_excess_pct": -0.2})
    assert totals == {"jobs_checked": 2, "png_rows_differing": 4, "png_idat_excess_pct": 0.5}


@pytest.mark.parametrize("h,w,sampling,quality", [(64, 64, "420", 90), (37, 53, "420", 75),
                                                  (48, 80, "444", 85)])
def test_jpeg_reader_equals_the_port_and_pil(h, w, sampling, quality):
    """The reader's pixels of a reference-made JPEG equal the port's (its
    host read, through a PNG of one tile) and libjpeg's (PIL), where PIL is
    installed."""
    import io

    import image_stitch_tpu_torch as port

    from stitchbench.common.tiles import photo_rows
    from stitchbench.reference import jpeg as ref
    from stitchbench.reference import png as ref_png
    from stitchbench.reference.jpeg_decode import decode

    data = ref.encode(photo_rows(SEED, 1, h, w), quality, sampling)
    mine = decode(data)
    png = port.concat_to_buffer({"inputs": [data], "layout": {"columns": 1},
                                 "outputFormat": "png"}, device="cpu")
    assert np.array_equal(mine, ref_png.decode(png))
    try:
        from PIL import Image
    except ImportError:
        return
    assert np.array_equal(mine, np.asarray(Image.open(io.BytesIO(data)).convert("RGBA")))
