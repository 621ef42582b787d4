"""Smoke run of the torch port on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printing its lines before the last:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions; exits non-zero without a usable CUDA device;
2. build: the hand-written kernels (image_stitch_tpu_torch/csrc) with nvcc
   for sm_90a, one process per source, timed as set-up;
3. kernels against their plain torch versions on the card, at the main
   paths' shapes: pack and merge on one 256 x 8192 4:4:4 band (98,304
   blocks) of random symbol streams with zero-length slots, an odd slot
   count and unaligned starts, at 14 and 26 words per block; filter select
   on 256 x 8192 RGBA8 and 256 x 4096 and 256 x 8192 RGBA16 bands of random
   bytes after a non-zero carry row, on a band of zeros (every filter ties
   and None must win) and on rows narrower than bpp; compositing of 50
   random segments of partial alpha into a 256 x 8192 band, and the exact
   rational tie case, which must count ties. Outputs must be equal;
4. main paths, through ``image_stitch_tpu_torch.concat_to_buffer(...,
   device="cuda")``, each output byte-identical to
   ``image_stitch_tpu.concat_to_buffer`` with ``backend="numpy"`` (the JAX
   package's host tier, which loads no jax). Every kernel's launch count
   is set to 0 just before each run and read just after it:
   - JPEG: an 8 x 8 grid of 1024 x 1024 photo-like RGBA PNG tiles (a 67 MP
     canvas, made from a seed) at q85 with restart rows 1 and 0 (4:4:4)
     and 1 (4:2:0); pack and merge must launch in each run and no band may
     be host-coded;
   - PNG: the same grid to PNG (level 6) and a 4 x 4 grid of 1024 x 1024
     RGBA16 tiles to PNG, filter select launched once for each band; a
     2048 x 2048 background under 50 sprites of 128 x 128 with partial
     alpha and random z order to PNG (compositing and filter select must
     launch) and to JPEG q85 (compositing, pack and merge must launch);
     then compositing against its plain version on the positioned runs'
     most crowded real band;
5. timing: per-band device time of each JPEG stage and of the kernel path
   against the plain torch path, and of each PNG-path kernel against its
   plain version (CUDA events, median and spread over repetitions after a
   warm-up); end-to-end MP/s of the torch path and of the host tier, in
   turns, for grid to JPEG, grid to PNG and positioned to PNG.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Any failure exits non-zero.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

SEED = 1234
TILE = 1024
GRID = 8
BAND_ROWS = 256
QUALITY = 85
GRID16 = 4
SIDE = 2048
SPRITES = 50
SPRITE = 128


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- inputs --- #


def photo_tile(rng: np.random.Generator, size: int) -> np.ndarray:
    """A photo-like RGBA tile: smooth colour fields, edges and sensor-like
    noise, opaque."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    out = np.empty((size, size, 4), np.uint8)
    for c in range(3):
        f1, f2, f3 = rng.uniform(1.0, 9.0, 3)
        p1, p2 = rng.uniform(0, 2 * np.pi, 2)
        field = (
            110
            + 60 * np.sin(2 * np.pi * f1 * x + p1) * np.cos(2 * np.pi * f2 * y + p2)
            + 35 * np.sign(np.sin(2 * np.pi * f3 * (x + y)))
        )
        noise = rng.normal(0.0, 3.0, (size, size)).astype(np.float32)
        out[..., c] = np.clip(field + noise, 0, 255).astype(np.uint8)
    out[..., 3] = 255
    return out


def png_bytes(rgba: np.ndarray) -> bytes:
    """Encode an (H, W, 4) uint8 or uint16 array as a PNG: filter 0 rows,
    one IDAT."""
    from image_stitch_tpu.codecs.png.writer import build_png
    from image_stitch_tpu.ops.pixel import band_to_bytes
    from image_stitch_tpu.types import PngHeader

    h, w, _ = rgba.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), band_to_bytes(rgba)], axis=1)
    header = PngHeader(width=w, height=h, bit_depth=8 * rgba.itemsize, color_type=6)
    return build_png(header, zlib.compress(raw.tobytes(), 1))


def photo_tile16(rng: np.random.Generator, size: int) -> np.ndarray:
    """A 16-bit photo-like RGBA tile: the 8-bit one scaled, with random low
    bytes, opaque."""
    t = photo_tile(rng, size).astype(np.uint16) * 256
    t[..., :3] += rng.integers(0, 256, (size, size, 3), dtype=np.uint16)
    t[..., 3] = 65535
    return t


def positioned_inputs(rng: np.random.Generator) -> list:
    """bench.py's positioned layout: a SIDE x SIDE photo-like background and
    SPRITES sprites of SPRITE x SPRITE at random places and z indices, each
    with its own colours and a 30-230 alpha ramp."""
    from image_stitch_tpu.types import PositionedImage

    inputs = [PositionedImage(x=0, y=0, source=png_bytes(photo_tile(rng, SIDE)))]
    for _ in range(SPRITES):
        sprite = photo_tile(rng, SPRITE)
        sprite[..., 3] = np.linspace(30, 230, SPRITE).astype(np.uint8)[None, :]
        inputs.append(PositionedImage(
            x=int(rng.integers(0, SIDE - 64)), y=int(rng.integers(0, SIDE - 64)),
            source=png_bytes(sprite), z_index=int(rng.integers(0, 10)),
        ))
    return inputs


# ---------------------------------------------------------------- timing --- #


def time_cuda(fn, reps: int = 20, warmup: int = 3) -> dict:
    """Per-repetition device time of ``fn`` in ms from CUDA events: median,
    min and max over ``reps`` after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in events]
    return {"median": statistics.median(ms), "min": min(ms), "max": max(ms), "reps": reps}


def fmt(t: dict) -> str:
    return f"{t['median']:.4f} ms (min {t['min']:.4f}, max {t['max']:.4f}, n={t['reps']})"


def as_u32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64) & 0xFFFFFFFF


# ---------------------------------------------------------------- phases --- #


def random_streams(rng: np.random.Generator, nb: int, n_sym: int, local_words: int):
    """Random (codes, lens, starts) symbol streams: ~30% zero-length slots,
    codes masked to their lengths, blocks within the local_words budget,
    and a first start that is not word-aligned."""
    lens = rng.integers(0, 17, size=(nb, n_sym)).astype(np.int32)
    lens[rng.random(lens.shape) < 0.3] = 0
    over = lens.sum(axis=1) > local_words * 32
    lens[over] = np.minimum(lens[over], 4)
    mask = ((1 << lens.astype(np.int64)) - 1).astype(np.int64)
    codes = (rng.integers(0, 1 << 16, size=(nb, n_sym)) & mask).astype(np.int32)
    starts = (
        np.concatenate([[0], np.cumsum(lens.sum(axis=1))[:-1]]) + int(rng.integers(1, 32))
    ).astype(np.int32)
    return codes, lens, starts


def check_kernels(dev: torch.device) -> dict:
    """Max |kernel - plain| per kernel over the random streams (each must
    be 0)."""
    from image_stitch_tpu_torch.ops import kernels as K

    errs = {"pack_blocks_aligned": 0, "merge_or": 0}
    rng = np.random.default_rng(SEED)
    nb = (BAND_ROWS // 8) * (GRID * TILE // 8) * 3
    for local_words in (12, 24):
        codes, lens, starts = random_streams(rng, nb, 65, local_words)
        c, l, s = (torch.from_numpy(a).to(dev) for a in (codes, lens, starts))
        got = K.pack_blocks_aligned(c, l, s, local_words)
        ref = K.pack_blocks_aligned_plain(c, l, s, local_words)
        torch.cuda.synchronize()
        err = int((as_u32(got) - as_u32(ref)).abs().max())
        errs["pack_blocks_aligned"] = max(errs["pack_blocks_aligned"], err)
        if err:
            fail(f"pack_blocks_aligned != plain at nb={nb}, AW={local_words + 2}: max |diff| {err}")
        n_words = int((starts[-1] + lens[-1].sum()) // 32) + 1
        d_got = K.merge_or(got, s, n_words)
        d_ref = K.merge_or_plain(ref, s, n_words)
        torch.cuda.synchronize()
        err = int((as_u32(d_got) - as_u32(d_ref)).abs().max())
        errs["merge_or"] = max(errs["merge_or"], err)
        if err:
            fail(f"merge_or != plain at nb={nb}, AW={local_words + 2}: max |diff| {err}")
        say(f"kernels == plain on random streams: nb={nb}, n_sym=65, AW={local_words + 2}, "
            f"first start bit {int(starts[0])}, {n_words} dense words")
    return errs


def random_segments(rng: np.random.Generator, n: int, h: int, w: int):
    """(metas, srcs) of n segments inside an h x w band, packed unpadded:
    random sizes, places and colours, alpha a 30-230 ramp."""
    metas, parts, off = [], [], 0
    for _ in range(n):
        sh, sw = int(rng.integers(1, h + 1)), int(rng.integers(1, min(w, 1024) + 1))
        px = rng.integers(0, 256, (sh, sw, 4), dtype=np.uint8)
        px[..., 3] = np.linspace(30, 230, sw).astype(np.uint8)[None, :]
        metas.append((int(rng.integers(0, h - sh + 1)), int(rng.integers(0, w - sw + 1)),
                      sh, sw, off, sw * 4))
        parts.append(px.reshape(-1))
        off += px.size
    return np.array(metas, np.int64), np.concatenate(parts)


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0


def filter_inputs(rng: np.random.Generator, dtype, dev: torch.device, width: int = GRID * TILE):
    """A BAND_ROWS x width RGBA band of random samples on the card and a
    random carry row."""
    band = rng.integers(0, np.iinfo(dtype).max + 1, (BAND_ROWS, width, 4), dtype=dtype)
    t = torch.from_numpy(band.view(np.uint8)).to(dev)
    if dtype == np.uint16:
        t = t.view(torch.uint16)
    prev = torch.from_numpy(rng.integers(1, 256, band[0].nbytes, dtype=np.uint8)).to(dev)
    return t, prev


def check_png_kernels(dev: torch.device) -> dict:
    """Max |kernel - plain| of filter select and compositing on the PNG
    paths' shapes (each must be 0)."""
    from image_stitch_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(SEED + 1)
    errs = {"filter_select": 0, "composite_segments": 0}

    def filt(band, prev, bpp, what):
        types, filtered = K.filter_select(band, prev, bpp)
        p_types, p_filtered = K.filter_select_plain(band, prev, bpp)
        torch.cuda.synchronize()
        err = max(max_err(types, p_types), max_err(filtered, p_filtered))
        errs["filter_select"] = max(errs["filter_select"], err)
        if err:
            fail(f"filter_select != plain on {what}: max |diff| {err}")
        say(f"filter_select == plain on {what}: {band.shape[0]} rows of "
            f"{filtered.shape[1]} B, bpp {bpp}, types used {torch.bincount(types.long(), minlength=5).tolist()}")
        return types

    # The grid PNG paths' bands: 8 and 4 tiles wide, RGBA8 and RGBA16; and
    # an RGBA16 band as wide as the RGBA8 grid.
    for dtype, bpp, width in ((np.uint8, 4, GRID * TILE), (np.uint16, 8, GRID16 * TILE),
                              (np.uint16, 8, GRID * TILE)):
        band, prev = filter_inputs(rng, dtype, dev, width)
        filt(band, prev, bpp, f"random {np.dtype(dtype).name} samples after a non-zero carry")
    zeros = torch.zeros((BAND_ROWS, GRID * TILE, 4), dtype=torch.uint8, device=dev)
    types = filt(zeros, torch.zeros(GRID * TILE * 4, dtype=torch.uint8, device=dev), 4,
                 "a band of zeros")
    if int(types.max()):
        fail("filter_select: on a band of zeros every filter ties and None must win")
    narrow = torch.from_numpy(rng.integers(0, 256, (16, 3), dtype=np.uint8)).to(dev)
    filt(narrow, torch.from_numpy(rng.integers(0, 256, 3, dtype=np.uint8)).to(dev), 4,
         "rows of 3 B at bpp 4")

    def comp(metas, srcs, bg, h, w, what):
        err, ties = check_composite(metas, srcs, bg, h, w, what)
        errs["composite_segments"] = max(errs["composite_segments"], err)
        return ties

    metas, srcs = (torch.from_numpy(a).to(dev) for a in
                   random_segments(rng, SPRITES, BAND_ROWS, GRID * TILE))
    comp(metas, srcs, (0, 0, 0, 0), BAND_ROWS, GRID * TILE, "random segments of partial alpha")
    # tests/unit/test_composite_device.py:54-68: (As 2, Ad 6, s 5, d 174).
    base = np.full((8, 8, 4), (174, 174, 174, 6), np.uint8)
    top = np.full((8, 8, 4), (5, 5, 5, 2), np.uint8)
    tie_metas = torch.tensor([[0, 0, 8, 8, 0, 32], [0, 0, 8, 8, 256, 32]], dtype=torch.int64,
                             device=dev)
    tie_srcs = torch.from_numpy(np.concatenate([base.reshape(-1), top.reshape(-1)])).to(dev)
    if comp(tie_metas, tie_srcs, (0, 0, 0, 0), 8, 8, "the exact rational tie") <= 0:
        fail("composite_segments counted no tie on the exact rational tie case")
    return errs


def check_composite(metas, srcs, bg, h: int, w: int, what: str) -> tuple[int, int]:
    """composite_segments against its plain version on one band: (max
    |diff| of band and tie count, which must be 0; the kernel's ties)."""
    from image_stitch_tpu_torch.ops import kernels as K

    band, ties = K.composite_segments(metas, srcs, bg, h, w)
    p_band, p_ties = K.composite_segments_plain(metas, srcs, bg, h, w)
    torch.cuda.synchronize()
    err = max(max_err(band, p_band), abs(int(ties) - int(p_ties)))
    if err:
        fail(f"composite_segments != plain on {what}: max |diff| {err}")
    say(f"composite_segments == plain on {what}: {metas.shape[0]} segments into "
        f"{h} x {w}, {int(ties)} ties")
    return err, int(ties)


def same_as_host(out: bytes, opts: dict, what: str) -> None:
    import image_stitch_tpu

    ref = image_stitch_tpu.concat_to_buffer({**opts, "backend": "numpy"})
    if out != ref:
        n = min(len(out), len(ref))
        first = next((i for i in range(n) if out[i] != ref[i]), n)
        fail(f"{what}: torch output ({len(out)} B) != host tier ({len(ref)} B), "
             f"first difference at byte {first}")


COUNTED = ("pack_blocks_aligned", "merge_or", "filter_select", "composite_segments")


def run_path(name: str, opts: dict, megapixels: float, dev: torch.device,
             must_launch: tuple[str, ...]):
    """One main-path run through ``image_stitch_tpu_torch.concat_to_buffer``
    with every kernel's launch count set to 0 just before it and read just
    after; each kernel in ``must_launch`` must have launched in this run.
    Returns (output, launches, counters)."""
    import image_stitch_tpu_torch
    from image_stitch_tpu_torch.ops import kernels as K

    counters = image_stitch_tpu_torch.EncodeCounters()
    for k in COUNTED:
        getattr(K, k).launches = 0
    t0 = time.perf_counter()
    out = image_stitch_tpu_torch.concat_to_buffer(opts, device=dev, counters=counters)
    secs = time.perf_counter() - t0
    launches = {k: getattr(K, k).launches for k in COUNTED}
    for k in must_launch:
        if launches[k] <= 0:
            fail(f"{name}: {k} was not launched")
    say(f"main path {name}: {megapixels:.1f} MP -> {len(out)} B, torch path {secs:.3f} s; "
        f"launches {launches}; counters {counters}")
    return out, launches, counters


def add_launches(total: dict, launches: dict) -> None:
    for k, n in launches.items():
        total[k] = total.get(k, 0) + n


def main_path(tiles_png: list[bytes], dev: torch.device, runs) -> dict:
    """The grid to JPEG at each (restart rows, sampling) of ``runs``, each
    byte-identical to the host tier; pack and merge must launch in each run
    and no band may be host-coded. Returns the launches summed over runs."""
    megapixels = GRID * GRID * TILE * TILE / 1e6
    base = {
        "inputs": tiles_png, "layout": {"columns": GRID}, "outputFormat": "jpeg",
        "jpegQuality": QUALITY, "bandHeight": BAND_ROWS,
    }
    total: dict = {}
    for ri, sampling in runs:
        opts = {**base, "jpegRestartIntervalRows": ri, "jpegSampling": sampling}
        name = f"grid -> JPEG ri={ri} {sampling} q{QUALITY}"
        out, launches, counters = run_path(name, opts, megapixels, dev,
                                           ("pack_blocks_aligned", "merge_or"))
        if counters.host_fallback_bands:
            fail(f"{name}: {counters.host_fallback_bands} bands were coded on the host")
        if out[:2] != b"\xff\xd8" or out[-2:] != b"\xff\xd9":
            fail(f"{name}: not a JPEG stream")
        same_as_host(out, opts, name)
        say(f"main path {name}: byte-identical to the numpy host tier")
        add_launches(total, launches)
    return total


def png_main_path(cases: list[tuple[str, dict, float, tuple[str, ...]]],
                  dev: torch.device) -> tuple[dict, int]:
    """Each (name, options, megapixels, kernels that must launch) case run
    on its own counts and held byte for byte against the host tier. A PNG
    run filters every band on the card, once; a positioned run blends bands
    on the card. The most crowded band that the positioned runs hand to
    composite_segments is held against its plain version afterwards.
    Returns (launches summed over the runs, that check's max |diff|)."""
    from image_stitch_tpu_torch.ops import composite_device

    real = composite_device.composite_segments
    seen: list[tuple] = []

    def capture(metas, srcs, bg, h, w):
        if not seen or metas.shape[0] > seen[0][0].shape[0]:
            seen[:] = [(metas, srcs, tuple(bg), h, w)]
        return real(metas, srcs, bg, h, w)

    total: dict = {}
    composite_device.composite_segments = capture
    try:
        for name, opts, mp, must_launch in cases:
            out, launches, counters = run_path(name, opts, mp, dev, must_launch)
            if opts["outputFormat"] == "png" and launches["filter_select"] != counters.png_bands:
                fail(f"{name}: {launches['filter_select']} filter launches for "
                     f"{counters.png_bands} bands")
            if "composite_segments" in must_launch and not counters.composite_bands_on_device:
                fail(f"{name}: no band was blended on the card")
            if counters.host_fallback_bands:
                fail(f"{name}: {counters.host_fallback_bands} bands were coded on the host")
            same_as_host(out, opts, name)
            say(f"main path {name}: byte-identical to the numpy host tier")
            add_launches(total, launches)
    finally:
        composite_device.composite_segments = real
    if not seen:
        fail("no positioned band reached composite_segments")
    metas, srcs, bg, h, w = seen[0]
    err, _ = check_composite(metas, srcs, bg, h, w, "the positioned path's most crowded band")
    return total, err


def png_kernel_timing(dev: torch.device) -> dict:
    """Device time of filter select (8-bit and 16-bit bands) and of
    compositing (50 segments), kernel against plain version."""
    from image_stitch_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(SEED + 2)
    t = {}
    for dtype, bpp, tag in ((np.uint8, 4, "filter8"), (np.uint16, 8, "filter16")):
        band, prev = filter_inputs(rng, dtype, dev)
        t[f"{tag}_kernel"] = time_cuda(lambda: K.filter_select(band, prev, bpp), reps=50)
        t[f"{tag}_plain"] = time_cuda(lambda: K.filter_select_plain(band, prev, bpp))
    metas, srcs = (torch.from_numpy(a).to(dev) for a in
                   random_segments(rng, SPRITES, BAND_ROWS, GRID * TILE))
    args = (metas, srcs, (0, 0, 0, 0), BAND_ROWS, GRID * TILE)
    t["composite_kernel"] = time_cuda(lambda: K.composite_segments(*args), reps=50)
    t["composite_plain"] = time_cuda(lambda: K.composite_segments_plain(*args))
    return t


def band_timing(tiles: list[np.ndarray], dev: torch.device) -> tuple[dict, dict]:
    """Per-stage device time of one 256 x 8192 4:4:4 restart band (32
    groups of one MCU row), kernel path against plain path; and max
    |kernel - plain| per kernel on that band (each must be 0)."""
    from image_stitch_tpu.codecs.jpeg.tables import quality_scaled_tables
    from image_stitch_tpu_torch.codecs.jpeg.encoder import local_words_for_quality
    from image_stitch_tpu_torch.ops import jpeg_entropy_device as E
    from image_stitch_tpu_torch.ops import kernels as K
    from image_stitch_tpu_torch.ops.device import jpeg_quantize

    lw = local_words_for_quality(QUALITY)
    band_np = np.concatenate([tiles[c][:BAND_ROWS, :, :3] for c in range(GRID)], axis=1)
    band = torch.from_numpy(np.ascontiguousarray(band_np)).to(dev)
    lq, cq = (torch.from_numpy(q).to(dev) for q in quality_scaled_tables(QUALITY))
    luts = E.build_entropy_luts(*_huffman_tables(), dev)
    n_groups = BAND_ROWS // 8

    blocks = jpeg_quantize(band, lq, cq)
    codes, lens = E._symbol_streams_flat(*blocks, luts, n_groups)
    starts, group_bits, _ = E._group_layout(lens, n_groups)
    used = int(((group_bits.to(torch.int64) + 31) >> 5).sum())
    need_per_group = -(-used // n_groups)
    cap_words = max(64, -(-need_per_group // 256) * 256)
    n_words = n_groups * cap_words

    local_k = K.pack_blocks_aligned(codes, lens, starts, lw)
    local_p = K.pack_blocks_aligned_plain(codes, lens, starts, lw)
    dense_k = K.merge_or(local_k, starts, n_words)
    dense_p = K.merge_or_plain(local_p, starts, n_words)
    torch.cuda.synchronize()
    err_pack = int((as_u32(local_k) - as_u32(local_p)).abs().max())
    err_merge = int((as_u32(dense_k) - as_u32(dense_p)).abs().max())
    if err_pack or err_merge:
        fail(f"real band: kernel != plain (pack {err_pack}, merge {err_merge})")
    bits = int(group_bits.sum())
    say(f"kernels == plain on a real band: nb={codes.shape[0]}, AW={lw + 2}, "
        f"{bits} bits = {bits / band_np.shape[0] / band_np.shape[1]:.3f} bits/px")

    def kernel_path():
        b = jpeg_quantize(band, lq, cq)
        return E.pack_groups_from_blocks(*b, luts, n_groups, cap_words, local_words=lw)

    def plain_path():
        b = jpeg_quantize(band, lq, cq)
        c, ln = E._symbol_streams_flat(*b, luts, n_groups)
        s, _, _ = E._group_layout(ln, n_groups)
        return K.merge_or_plain(K.pack_blocks_aligned_plain(c, ln, s, lw), s, n_words)

    t = {
        "quantize": time_cuda(lambda: jpeg_quantize(band, lq, cq)),
        "symbols": time_cuda(lambda: E._symbol_streams_flat(*blocks, luts, n_groups)),
        "layout": time_cuda(lambda: E._group_layout(lens, n_groups)),
        "pack_kernel": time_cuda(lambda: K.pack_blocks_aligned(codes, lens, starts, lw), reps=50),
        "pack_plain": time_cuda(lambda: K.pack_blocks_aligned_plain(codes, lens, starts, lw)),
        "merge_kernel": time_cuda(lambda: K.merge_or(local_k, starts, n_words), reps=50),
        "merge_plain": time_cuda(lambda: K.merge_or_plain(local_p, starts, n_words)),
        "band_kernel_path": time_cuda(kernel_path),
        "band_plain_path": time_cuda(plain_path),
    }
    return t, {"pack_blocks_aligned": err_pack, "merge_or": err_merge}


def _huffman_tables():
    from image_stitch_tpu.codecs.jpeg.tables import (
        STD_AC_CHROMA_BITS, STD_AC_CHROMA_VALS, STD_AC_LUMA_BITS, STD_AC_LUMA_VALS,
        STD_DC_CHROMA_BITS, STD_DC_CHROMA_VALS, STD_DC_LUMA_BITS, STD_DC_LUMA_VALS,
        build_huffman_codes,
    )

    return (
        build_huffman_codes(STD_DC_LUMA_BITS, STD_DC_LUMA_VALS),
        build_huffman_codes(STD_AC_LUMA_BITS, STD_AC_LUMA_VALS),
        build_huffman_codes(STD_DC_CHROMA_BITS, STD_DC_CHROMA_VALS),
        build_huffman_codes(STD_AC_CHROMA_BITS, STD_AC_CHROMA_VALS),
    )


def e2e_rates(opts: dict, megapixels: float, dev: torch.device) -> dict:
    """End-to-end MP/s of ``opts``, torch path and numpy host tier in turns
    (torch, host, host, torch)."""
    import image_stitch_tpu
    import image_stitch_tpu_torch

    rates = {"torch": [], "host": []}
    for which in ("torch", "host", "host", "torch"):
        t0 = time.perf_counter()
        if which == "torch":
            image_stitch_tpu_torch.concat_to_buffer(opts, device=dev)
        else:
            image_stitch_tpu.concat_to_buffer({**opts, "backend": "numpy"})
        rates[which].append(megapixels / (time.perf_counter() - t0))
    return rates


def host_assembly_rate(tiles_png: list[bytes]) -> float:
    """MP/s of the host layers alone (PNG decode, layout, band assembly) on
    the grid, with no encode: the ceiling of either end-to-end path."""
    from image_stitch_tpu.core import CoreStreamingConcatenator

    opts = {
        "inputs": tiles_png, "layout": {"columns": GRID}, "outputFormat": "jpeg",
        "bandHeight": BAND_ROWS, "backend": "numpy",
    }
    t0 = time.perf_counter()
    px = sum(b.shape[0] * b.shape[1] for b in CoreStreamingConcatenator(opts).stream_bands())
    return px / 1e6 / (time.perf_counter() - t0)


def host_deflate_rate(tiles: list[np.ndarray], dev: torch.device) -> float:
    """MP/s of the host's streaming deflate alone (level 6, as the PNG
    encoder runs it) over one grid band's filtered rows, pushed four times."""
    from image_stitch_tpu.io.deflate import StreamingDeflator
    from image_stitch_tpu_torch.ops.device import TorchBackend

    band = np.concatenate([tiles[c][:BAND_ROWS] for c in range(GRID)], axis=1)
    types, filtered, _ = TorchBackend(dev).png_filter_band(band, None)
    rows = np.concatenate([types[:, None], filtered], axis=1).tobytes()
    deflator = StreamingDeflator(level=6, on_data=lambda _: None, content_hint="filtered_png")
    t0 = time.perf_counter()
    for _ in range(4):
        deflator.push(rows)
    deflator.finish()
    return 4 * band.shape[0] * band.shape[1] / 1e6 / (time.perf_counter() - t0)


def device_profile(opts: dict, dev: torch.device) -> dict:
    """One torch run of ``opts`` under torch.profiler: wall time, the summed
    time and count of device activities (kernels and copies, which run on
    one stream here), and the eight with the most device time."""
    import image_stitch_tpu_torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        image_stitch_tpu_torch.concat_to_buffer(opts, device=dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    return {"wall_ms": wall_ms, "device_ms": sum(r[1] for r in rows),
            "activities": sum(r[2] for r in rows), "top": rows[:8]}


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA GPU")
    dev = torch.device("cuda", 0)

    # 1. Environment.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    kind = torch.cuda.get_device_name(0)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}, "
        f"count {torch.cuda.device_count()}, python {sys.version.split()[0]}")

    # 2. Build.
    from image_stitch_tpu_torch._build import load_cuda_kernels

    from image_stitch_tpu.native import get_native_lib

    t0 = time.perf_counter()
    load_cuda_kernels()
    say(f"build: nvcc sm_90a kernels loaded in {time.perf_counter() - t0:.2f} s (set-up)")
    t0 = time.perf_counter()
    if get_native_lib() is None:
        fail("the host tier's C++ library (image_stitch_tpu/native) did not build")
    say(f"build: host tier C++ library loaded in {time.perf_counter() - t0:.2f} s (set-up)")

    # 3. Kernels against their plain versions at the main paths' shapes.
    errs = check_kernels(dev)
    errs.update(check_png_kernels(dev))

    # 4. Main paths.
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    tiles = [photo_tile(rng, TILE) for _ in range(GRID * GRID)]
    tiles_png = [png_bytes(t) for t in tiles]
    tiles16_png = [png_bytes(photo_tile16(rng, TILE)) for _ in range(GRID16 * GRID16)]
    sprites = positioned_inputs(rng)
    say(f"inputs: {GRID}x{GRID} grid of {TILE}x{TILE} RGBA PNG tiles, "
        f"{sum(map(len, tiles_png)) / 1e6:.1f} MB; {GRID16}x{GRID16} RGBA16 tiles, "
        f"{sum(map(len, tiles16_png)) / 1e6:.1f} MB; {SIDE}x{SIDE} background + {SPRITES} "
        f"sprites; made in {time.perf_counter() - t0:.2f} s")
    launches = main_path(tiles_png, dev, [(1, "444"), (0, "444"), (1, "420")])
    grid_png = {"inputs": tiles_png, "layout": {"columns": GRID}, "outputFormat": "png",
                "pngCompressionLevel": 6, "bandHeight": BAND_ROWS}
    grid16_png = {**grid_png, "inputs": tiles16_png, "layout": {"columns": GRID16}}
    positioned = {"inputs": sprites, "layout": {"width": SIDE, "height": SIDE},
                  "outputFormat": "png", "bandHeight": BAND_ROWS}
    mp_grid, mp_side = GRID * GRID * TILE * TILE / 1e6, SIDE * SIDE / 1e6
    png_launches, comp_err = png_main_path([
        ("grid -> PNG 8-bit level 6", grid_png, mp_grid, ("filter_select",)),
        ("grid -> PNG 16-bit level 6", grid16_png, GRID16 * GRID16 * TILE * TILE / 1e6,
         ("filter_select",)),
        ("positioned -> PNG", positioned, mp_side, ("composite_segments", "filter_select")),
        (f"positioned -> JPEG q{QUALITY}",
         {**positioned, "outputFormat": "jpeg", "jpegQuality": QUALITY}, mp_side,
         ("composite_segments", "pack_blocks_aligned", "merge_or")),
    ], dev)
    add_launches(launches, png_launches)
    errs["composite_segments"] = max(errs["composite_segments"], comp_err)
    say(f"main path launches, summed over the runs: {launches}")

    # 5. Timing.
    t, band_errs = band_timing(tiles, dev)
    errs = {k: max(v, band_errs.get(k, 0)) for k, v in errs.items()}
    for name, v in t.items():
        say(f"band 256x8192 444 ri=1 q{QUALITY} {name}: {fmt(v)} [{card}]")
    t.update(png_kernel_timing(dev))
    for name, what in (("filter8", "RGBA8 band 256x32768 B"), ("filter16", "RGBA16 band 256x65536 B"),
                       ("composite", f"{SPRITES} segments into 256x8192")):
        for which in ("kernel", "plain"):
            say(f"{name}_{which} ({what}): {fmt(t[f'{name}_{which}'])} [{card}]")
    grid_jpeg = {"inputs": tiles_png, "layout": {"columns": GRID}, "outputFormat": "jpeg",
                 "jpegQuality": QUALITY, "bandHeight": BAND_ROWS, "jpegRestartIntervalRows": 1}
    for name, opts, mp in ((f"grid_jpeg 67.1 MP ri=1 q{QUALITY}", grid_jpeg, mp_grid),
                           ("grid_png 67.1 MP level 6", grid_png, mp_grid),
                           (f"positioned_png {mp_side:.1f} MP", positioned, mp_side)):
        for which, r in e2e_rates(opts, mp, dev).items():
            say(f"e2e {name} {which}: {', '.join(f'{x:.2f}' for x in r)} MP/s [{card}]")
    say(f"host decode + assembly alone (no encode): {host_assembly_rate(tiles_png):.2f} MP/s "
        f"[{card}]")
    say(f"host deflate alone (level 6, filtered rows): {host_deflate_rate(tiles, dev):.2f} MP/s "
        f"[{card}]")
    n_bands = GRID * TILE // BAND_ROWS
    for name, opts in (("grid_jpeg ri=1", grid_jpeg), ("grid_png", grid_png)):
        p = device_profile(opts, dev)
        say(f"profiled torch run {name}: wall {p['wall_ms']:.1f} ms, device busy "
            f"{p['device_ms']:.1f} ms ({100 * p['device_ms'] / p['wall_ms']:.2f}% of wall), "
            f"{p['activities']} device activities = {p['activities'] / n_bands:.1f} per band "
            f"[{card}]")
        for key, ms, count in p["top"]:
            say(f"  device {ms:9.3f} ms  x{count:<6d} {key[:100]}")

    if "jax" in sys.modules:
        fail("jax was imported")
    kernels = [
        {"name": "pack_blocks_aligned", "route": "cuda",
         "source": "image_stitch_tpu_torch/csrc/pack.cu",
         "replaces": "image_stitch_tpu/ops/pallas_kernels.py:172",
         "launches": launches["pack_blocks_aligned"],
         "max_abs_err": errs["pack_blocks_aligned"],
         "ms": t["pack_kernel"]["median"], "plain_ms": t["pack_plain"]["median"]},
        {"name": "merge_or", "route": "cuda",
         "source": "image_stitch_tpu_torch/csrc/merge.cu",
         "replaces": "image_stitch_tpu/ops/jpeg_entropy_device.py:934",
         "launches": launches["merge_or"], "max_abs_err": errs["merge_or"],
         "ms": t["merge_kernel"]["median"], "plain_ms": t["merge_plain"]["median"]},
        {"name": "filter_select", "route": "cuda",
         "source": "image_stitch_tpu_torch/csrc/filter.cu",
         "replaces": "image_stitch_tpu/ops/pallas_kernels.py:33",
         "launches": launches["filter_select"], "max_abs_err": errs["filter_select"],
         "ms": t["filter8_kernel"]["median"], "plain_ms": t["filter8_plain"]["median"]},
        {"name": "composite_segments", "route": "cuda",
         "source": "image_stitch_tpu_torch/csrc/composite.cu",
         "replaces": "image_stitch_tpu/ops/composite_device.py:84",
         "launches": launches["composite_segments"],
         "max_abs_err": errs["composite_segments"],
         "ms": t["composite_kernel"]["median"], "plain_ms": t["composite_plain"]["median"]},
    ]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
