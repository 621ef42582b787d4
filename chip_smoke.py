"""Smoke run of the torch port on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printing its lines before the last:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions; exits non-zero without a usable CUDA device;
2. build: the hand-written kernels (image_stitch_tpu_torch/csrc) with nvcc
   for sm_90a, timed as set-up;
3. kernels against their plain torch versions on the card, at the main
   path's shape (one 256 x 8192 4:4:4 band: 98,304 blocks), on random
   symbol streams with zero-length slots, an odd slot count and unaligned
   starts, with 14 and 26 words per block; outputs must be equal;
4. main path: an 8 x 8 grid of 1024 x 1024 photo-like RGBA PNG tiles (a
   67 MP canvas, made from a seed) through
   ``image_stitch_tpu_torch.concat_to_buffer(..., device="cuda")`` at q85
   with restart rows 1 and 0 (4:4:4) and 1 (4:2:0); each output must be
   byte-identical to ``image_stitch_tpu.concat_to_buffer`` with
   ``backend="numpy"`` (the JAX package's host tier, which loads no jax),
   both kernels must have launched and no band may be host-coded;
5. timing: per-band device time of each stage and of the kernel path
   against the plain torch path (CUDA events, median and spread over
   repetitions after a warm-up), and end-to-end MP/s of the torch path and
   of the host tier.

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
    """Encode an (H, W, 4) uint8 array as a PNG: filter 0 rows, one IDAT."""
    from image_stitch_tpu.codecs.png.writer import build_png
    from image_stitch_tpu.types import PngHeader

    h, w, _ = rgba.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgba.reshape(h, w * 4)], axis=1)
    header = PngHeader(width=w, height=h, bit_depth=8, color_type=6)
    return build_png(header, zlib.compress(raw.tobytes(), 1))


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


def main_path(tiles_png: list[bytes], dev: torch.device, runs) -> dict:
    import image_stitch_tpu
    import image_stitch_tpu_torch
    from image_stitch_tpu_torch.ops import kernels as K

    megapixels = GRID * GRID * TILE * TILE / 1e6
    base = {
        "inputs": tiles_png, "layout": {"columns": GRID}, "outputFormat": "jpeg",
        "jpegQuality": QUALITY, "bandHeight": BAND_ROWS,
    }
    counters = image_stitch_tpu_torch.EncodeCounters()
    K.pack_blocks_aligned.launches = 0
    K.merge_or.launches = 0
    outs, secs = [], []
    for ri, sampling in runs:
        opts = {**base, "jpegRestartIntervalRows": ri, "jpegSampling": sampling}
        t0 = time.perf_counter()
        outs.append(image_stitch_tpu_torch.concat_to_buffer(opts, device=dev, counters=counters))
        secs.append(time.perf_counter() - t0)
    launches = {"pack_blocks_aligned": K.pack_blocks_aligned.launches,
                "merge_or": K.merge_or.launches}
    for (ri, sampling), out, s in zip(runs, outs, secs):
        opts = {**base, "jpegRestartIntervalRows": ri, "jpegSampling": sampling}
        ref = image_stitch_tpu.concat_to_buffer({**opts, "backend": "numpy"})
        if out != ref:
            n = min(len(out), len(ref))
            first = next((i for i in range(n) if out[i] != ref[i]), n)
            fail(f"ri={ri} {sampling}: torch output ({len(out)} B) != host tier "
                 f"({len(ref)} B), first difference at byte {first}")
        if out[:2] != b"\xff\xd8" or out[-2:] != b"\xff\xd9":
            fail(f"ri={ri} {sampling}: not a JPEG stream")
        say(f"main path ri={ri} {sampling} q{QUALITY}: {megapixels:.1f} MP -> {len(out)} B, "
            f"byte-identical to the numpy host tier; torch path {s:.3f} s")
    for name, n in launches.items():
        if n <= 0:
            fail(f"{name} was not launched on the main path")
    if counters.host_fallback_bands:
        fail(f"{counters.host_fallback_bands} bands were coded on the host")
    say(f"main path launches: {launches}; encoder counters: {counters}")
    return launches


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


def e2e_rates(tiles_png: list[bytes], dev: torch.device) -> dict:
    """End-to-end MP/s at ri=1 4:4:4, torch path and numpy host tier in
    turns (torch, host, host, torch)."""
    import image_stitch_tpu
    import image_stitch_tpu_torch

    opts = {
        "inputs": tiles_png, "layout": {"columns": GRID}, "outputFormat": "jpeg",
        "jpegQuality": QUALITY, "bandHeight": BAND_ROWS, "jpegRestartIntervalRows": 1,
    }
    megapixels = GRID * GRID * TILE * TILE / 1e6
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


def device_profile(tiles_png: list[bytes], dev: torch.device) -> dict:
    """One ri=1 4:4:4 torch run under torch.profiler: wall time, the summed
    time and count of device activities (kernels and copies, which run on
    one stream here), and the eight with the most device time."""
    import image_stitch_tpu_torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    opts = {
        "inputs": tiles_png, "layout": {"columns": GRID}, "outputFormat": "jpeg",
        "jpegQuality": QUALITY, "bandHeight": BAND_ROWS, "jpegRestartIntervalRows": 1,
    }
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

    # 3. Kernels against their plain versions at the main path's shape.
    errs = check_kernels(dev)

    # 4. Main path.
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    tiles = [photo_tile(rng, TILE) for _ in range(GRID * GRID)]
    tiles_png = [png_bytes(t) for t in tiles]
    say(f"inputs: {GRID}x{GRID} grid of {TILE}x{TILE} RGBA PNG tiles, "
        f"{sum(map(len, tiles_png)) / 1e6:.1f} MB, made in {time.perf_counter() - t0:.2f} s")
    launches = main_path(tiles_png, dev, [(1, "444"), (0, "444"), (1, "420")])

    # 5. Timing.
    t, band_errs = band_timing(tiles, dev)
    errs = {k: max(v, band_errs[k]) for k, v in errs.items()}
    for name, v in t.items():
        say(f"band 256x8192 444 ri=1 q{QUALITY} {name}: {fmt(v)} [{card}]")
    rates = e2e_rates(tiles_png, dev)
    for which, r in rates.items():
        say(f"e2e grid_jpeg 67.1 MP ri=1 q{QUALITY} {which}: "
            f"{', '.join(f'{x:.2f}' for x in r)} MP/s [{card}]")
    say(f"host decode + assembly alone (no encode): {host_assembly_rate(tiles_png):.2f} MP/s "
        f"[{card}]")
    p = device_profile(tiles_png, dev)
    n_bands = GRID * TILE // BAND_ROWS
    say(f"profiled torch run ri=1: wall {p['wall_ms']:.1f} ms, device busy "
        f"{p['device_ms']:.1f} ms ({100 * p['device_ms'] / p['wall_ms']:.2f}% of wall), "
        f"{p['activities']} device activities = {p['activities'] / n_bands:.1f} per band [{card}]")
    for name, ms, count in p["top"]:
        say(f"  device {ms:9.3f} ms  x{count:<6d} {name[:100]}")

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
    ]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
