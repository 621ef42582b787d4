"""Hand-written Hopper kernels, with their plain torch versions.

- ``pack_merge`` (csrc/pack_merge.cu) replaces the Pallas kernel
  ``image_stitch_tpu/ops/pallas_kernels.py::_pack_kernel`` and the merge
  that follows it, ``ops/jpeg_entropy_device.py::_merge_aligned_hybrid``;
  its plain version is ``merge_or_plain`` of ``pack_blocks_aligned_plain``;
- ``filter_select`` (csrc/filter.cu) replaces the Pallas kernel
  ``ops/pallas_kernels.py::_filter_kernel`` with the band's byte view;
- ``composite_segments`` (csrc/composite.cu) replaces the compositor scan
  ``ops/composite_device.py::_composite_run_trace``;
- ``idct_dequant`` (csrc/idct.cu) and ``ycc_rgba`` (csrc/ycc.cu) replace
  the JPEG band decode program, ``ops/jpeg_idct_device.py::
  decode_plane_trace`` and the upsampling and colour of
  ``codecs/jpeg/device_decoder.py::_decode_band_trace``; each kernel takes a
  table of windows, so ``idct_dequant_batch`` and ``ycc_rgba_batch`` decode
  every tile of a band in one launch each, and the single-window calls are
  batches of one; their plain versions are loops of
  ``ops/jpeg_idct_device.decode_plane`` and ``window_to_rgba``;
- ``fdct_quant`` (csrc/fdct_quant.cu) replaces the quantize programs
  ``ops/device.py::jpeg_quantize_trace`` and ``jpeg_quantize_420_trace``
  (plain: ``ops/jpeg_dct.band_to_blocks_islow`` and ``_420``);
- ``symbol_streams`` (csrc/symbols.cu) replaces
  ``ops/jpeg_entropy_device.py::_symbol_streams_flat`` and
  ``_symbol_streams`` (plain: ``ops/jpeg_entropy_device.
  symbol_streams_plain``);
- ``group_layout`` (csrc/layout.cu) replaces the layout of
  ``ops/jpeg_entropy_device.py::jpeg_pack_groups_from_blocks_trace`` and
  ``entropy_pack_trace_v2``: the sums and cumulative sums between the symbol
  streams and the pack (plain: ``ops/jpeg_entropy_device.
  group_layout_plain``);
- ``grid_dual`` (csrc/grid_dual.cu) replaces the fused uniform-grid step
  ``ops/fused.py::fused_grid_dual_step`` (and its PNG and JPEG halves):
  the tile stack read in place into the filter select and the quantize
  (plain: ``grid_dual_plain``, the rows assembled, then
  ``filter_select_plain`` and ``jpeg_dct.band_to_blocks_islow``).

The sources' head comments say what bounds each on the H100 and what the
design does about it.

Bit words are stored as int32 tensors holding uint32 bit patterns: the
kernels read them as ``uint32_t``. The plain versions work in int64 masked
to 32 bits, because torch on the CPU has no uint32 shifts or compares.

Each wrapper takes its plain version for a CPU tensor and launches its
kernel for a CUDA tensor, on the current stream; there is no fallback from
one to the other. ``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from .._build import load_cuda_kernels
from ..codecs.jpeg.tables import ZIGZAG
from .jpeg_dct import band_to_blocks_islow, band_to_blocks_islow_420
from .jpeg_idct_device import decode_plane, window_to_rgba

MASK32 = 0xFFFFFFFF
# Largest words-per-block the kernel takes (csrc/pack_merge.cuh PACK_MAX_AW).
MAX_AW = 32
# group_layout and pack_merge hold a block's start bit as int32
# (csrc/layout.cu, csrc/pack_merge.cu): a dispatch's stream stays below this.
MAX_STREAM_BITS = 1 << 31


def stream_fits_int32(n_blocks: int, local_words: int) -> bool:
    """Whether every start bit of a dispatch of ``n_blocks`` blocks, each
    packed in at most ``local_words`` words, stays below 2^31. The bound is
    ``n_blocks * (local_words + 1) * 32`` bits: a block within its budget
    holds at most ``local_words`` words, and the layout adds less than one
    word a block (a restart group's padding to whole words, the carried
    stream's leading bits). A dispatch with a block over budget is packed
    again or coded on the host, whatever its start bits were."""
    return n_blocks * (local_words + 1) * 32 < MAX_STREAM_BITS


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launch(fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: cudaGetLastError() = {err}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# --------------------------------------------------------------------------- #
# JPEG entropy pack and merge
# --------------------------------------------------------------------------- #


def pack_blocks_aligned_plain(codes: torch.Tensor, lens: torch.Tensor,
                              starts: torch.Tensor, local_words: int) -> torch.Tensor:
    """Plain torch phase-1 pack, the same arithmetic as csrc/pack_merge.cuh.

    codes, lens: (nb, n_sym) int32; starts: (nb,) int32 global start bits.
    Returns (nb, local_words + 2) int32 words pre-aligned to each block's
    start, as ``_pack_blocks_aligned(...).T`` in the JAX package."""
    nb, n_sym = codes.shape
    n_aw = local_words + 2
    if n_sym % 2:
        codes = torch.nn.functional.pad(codes, (0, 1))
        lens = torch.nn.functional.pad(lens, (0, 1))
        n_sym += 1
    codes = codes.to(torch.int64) & MASK32
    lens = lens.to(torch.int64)
    lane = torch.arange(n_aw, device=codes.device)[None, :]
    local = torch.zeros((nb, n_aw), dtype=torch.int64, device=codes.device)
    off = starts.to(torch.int64) & 31

    def shl(x, s):
        return torch.where(s < 32, (x << s.clamp(0, 31)) & MASK32, 0)

    def shr(x, s):
        return torch.where(s < 32, x >> s.clamp(0, 31), 0)

    for s in range(0, n_sym, 2):
        c1, c2 = codes[:, s], codes[:, s + 1]
        l1, l2 = lens[:, s], lens[:, s + 1]
        v_lo = shl(c1, l2) | c2
        v_hi = torch.where(l2 == 0, 0, shr(c1, (32 - l2).clamp(0, 31)))
        end = off + l1 + l2
        sh = (32 - (end & 31)) & 31
        inv = (32 - sh).clamp(0, 31)
        lo_spill = torch.where(sh == 0, 0, v_lo >> inv)
        hi_spill = torch.where(sh == 0, 0, v_hi >> inv)
        d_lo = (v_lo << sh) & MASK32
        d_mid = ((v_hi << sh) & MASK32) | lo_spill
        w_e = (end - 1) >> 5
        for w, d in ((w_e, d_lo), (w_e - 1, d_mid), (w_e - 2, hi_spill)):
            hit = lane == w.clamp(0, n_aw - 1)[:, None]
            local |= torch.where(hit, d[:, None], 0)
        off = end
    return local.to(torch.int32)


def merge_or_plain(local: torch.Tensor, starts: torch.Tensor,
                   n_words: int) -> torch.Tensor:
    """Plain torch merge: an int64 ``index_add_`` of each block's words at
    ``(starts >> 5) + c``, dropping indices >= n_words. Blocks' bit ranges
    are disjoint, so ADD equals OR. Returns (n_words,) int32."""
    nb, n_aw = local.shape
    idx = ((starts.to(torch.int64) >> 5)[:, None]
           + torch.arange(n_aw, device=local.device)[None, :]).reshape(-1)
    vals = (local.to(torch.int64) & MASK32).reshape(-1)
    keep = idx < n_words
    dense = torch.zeros(n_words, dtype=torch.int64, device=local.device)
    dense.index_add_(0, idx[keep], vals[keep])
    return dense.to(torch.int32)


def pack_merge_plain(codes: torch.Tensor, lens: torch.Tensor, starts: torch.Tensor,
                     local_words: int, n_words: int) -> torch.Tensor:
    """The plain version of ``pack_merge``: the phase-1 pack, then the
    merge, with the (nb, local_words + 2) words between them."""
    return merge_or_plain(pack_blocks_aligned_plain(codes, lens, starts, local_words),
                          starts, n_words)


def pack_merge(codes: torch.Tensor, lens: torch.Tensor, starts: torch.Tensor,
               local_words: int, n_words: int) -> torch.Tensor:
    """Pack each block's (nb, n_sym) int32 symbol slots at its (nb,) int32
    global start bit and merge the words into a zeroed (n_words,) int32
    stream; indices past n_words are dropped. Raises where the start bits
    could pass 2^31 (``stream_fits_int32``). Launches csrc/pack_merge.cu
    for CUDA tensors; the plain version for CPU tensors."""
    nb, n_sym = codes.shape
    device = codes.device
    if not stream_fits_int32(nb, local_words):
        raise ValueError(f"{nb} blocks of {local_words} words may pass 2^31 start bits")
    _check(codes, "codes", torch.int32, 2, device)
    _check(lens, "lens", torch.int32, 2, device)
    _check(starts, "starts", torch.int32, 1, device)
    n_aw = local_words + 2
    if lens.shape != codes.shape or starts.shape[0] != nb:
        raise ValueError(
            f"shapes differ: codes {tuple(codes.shape)}, lens "
            f"{tuple(lens.shape)}, starts {tuple(starts.shape)}"
        )
    if not 1 <= n_aw <= MAX_AW:
        raise ValueError(f"local_words + 2 = {n_aw} outside [1, {MAX_AW}]")
    if not 0 <= n_words < 1 << 31:
        raise ValueError(f"n_words = {n_words} outside [0, 2^31)")
    if device.type == "cpu":
        return pack_merge_plain(codes, lens, starts, local_words, n_words)
    if device.type != "cuda":
        raise ValueError(f"pack_merge: unsupported device {device}")
    dense = torch.zeros(n_words, dtype=torch.int32, device=device)
    if nb == 0 or n_sym == 0 or n_words == 0:
        return dense
    lib = load_cuda_kernels()
    _launch(
        lib.pack_merge_launch, codes.data_ptr(), lens.data_ptr(), starts.data_ptr(),
        dense.data_ptr(), nb, n_sym, n_aw, n_words, _stream(device),
    )
    pack_merge.launches += 1
    return dense


pack_merge.launches = 0


# --------------------------------------------------------------------------- #
# PNG filter select
# --------------------------------------------------------------------------- #

# Longest row the kernel takes: its int32 sums stay below 128 * n.
MAX_FILTER_ROW = 1 << 24
# The kernels of csrc/filter.cu, by the variant number its launcher takes:
# the byte kernel, and the word kernel for bpp 4 and 8 with 4 B or 16 B
# loads.
FILTER_VARIANTS = ("bytes", "word4", "word4_vec16", "word8", "word8_vec16")


def filter_variant(n: int, bpp: int, *addresses: int) -> int:
    """The csrc/filter.cu kernel for rows of ``n`` bytes at ``bpp`` whose
    band, carry row and output start at ``addresses``: the word kernel where
    bpp is 4 or 8 and rows and pointers are 4 B aligned, with 16 B loads
    where they are 16 B aligned; else the byte kernel. An index into
    ``FILTER_VARIANTS``."""
    if bpp not in (4, 8) or n % 4 or any(a % 4 for a in addresses):
        return 0
    vec = n % 16 == 0 and not any(a % 16 for a in addresses)
    return (1 if bpp == 4 else 3) + int(vec)


def png_bytes(band: torch.Tensor) -> torch.Tensor:
    """(H, ...) uint8 or uint16 band -> (H, N) uint8 rows in PNG byte order,
    16-bit samples big-endian (``image_stitch_tpu.ops.pixel.band_to_bytes``).
    A view for uint8; a copy for uint16."""
    h = band.shape[0]
    if band.dtype == torch.uint16:
        return band.reshape(h, -1).view(torch.uint8).reshape(h, -1, 2).flip(-1).reshape(h, -1)
    return band.reshape(h, -1)


def _shift_right(x: torch.Tensor, k: int) -> torch.Tensor:
    """Each row's bytes k places later, zeros in front."""
    out = torch.zeros_like(x)
    if x.shape[1] > k:
        out[:, k:] = x[:, : x.shape[1] - k]
    return out


def filter_select_plain(band: torch.Tensor, prev: torch.Tensor,
                        bpp: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch filter select in int32: ``filter_select_trace``
    (image_stitch_tpu/ops/device.py:59-93) with the strict-``<`` chain of
    ``_filter_kernel``. Returns (types (H,) uint8, filtered (H, N) uint8)."""
    raw = png_bytes(band).to(torch.int32)
    h, n = raw.shape
    up = torch.cat([prev.to(torch.int32)[None, :], raw[:-1]], dim=0)
    left = _shift_right(raw, bpp)
    upleft = _shift_right(up, bpp)
    p = left + up - upleft
    pa, pb, pc = (p - left).abs(), (p - up).abs(), (p - upleft).abs()
    paeth = torch.where((pa <= pb) & (pa <= pc), left, torch.where(pb <= pc, up, upleft))
    cand = torch.stack([
        raw,
        (raw - left) & 0xFF,
        (raw - up) & 0xFF,
        (raw - ((left + up) >> 1)) & 0xFF,
        (raw - paeth) & 0xFF,
    ])
    sums = torch.where(cand > 127, 256 - cand, cand).sum(dim=2, dtype=torch.int32)
    best = sums[0]
    choice = torch.zeros_like(best)
    for k in range(1, 5):
        better = sums[k] < best
        choice = torch.where(better, k, choice)
        best = torch.where(better, sums[k], best)
    filtered = cand.gather(0, choice[None, :, None].expand(1, h, n))[0]
    return choice.to(torch.uint8), filtered.to(torch.uint8)


def filter_select(band: torch.Tensor, prev: torch.Tensor,
                  bpp: int) -> tuple[torch.Tensor, torch.Tensor]:
    """PNG filter select over a band: ``band`` (H, ...) contiguous, uint8
    bytes or uint16 samples (read big-endian), N bytes a row; ``prev`` the
    (N,) uint8 carry row (zeros at the image start). Returns (types (H,)
    uint8, filtered (H, N) uint8). Launches csrc/filter.cu for CUDA tensors
    (the kernel ``filter_variant`` picks); the plain version for CPU
    tensors."""
    device = band.device
    if band.dtype not in (torch.uint8, torch.uint16):
        raise TypeError(f"band: expected uint8 or uint16, got {band.dtype}")
    if band.ndim < 2:
        raise ValueError(f"band: expected (H, ...), got shape {tuple(band.shape)}")
    if not band.is_contiguous():
        raise ValueError("band: must be contiguous")
    h = band.shape[0]
    n = math.prod(band.shape[1:]) * band.element_size()
    _check(prev, "prev", torch.uint8, 1, device)
    if prev.shape[0] != n:
        raise ValueError(f"prev has {prev.shape[0]} bytes, the band's rows {n}")
    if not 1 <= bpp <= 8:
        raise ValueError(f"bpp = {bpp} outside [1, 8]")
    if n >= MAX_FILTER_ROW:
        raise ValueError(f"rows of {n} bytes: the kernel takes fewer than {MAX_FILTER_ROW}")
    if device.type == "cpu":
        return filter_select_plain(band, prev, bpp)
    if device.type != "cuda":
        raise ValueError(f"filter_select: unsupported device {device}")
    types = torch.empty(h, dtype=torch.uint8, device=device)
    filtered = torch.empty((h, n), dtype=torch.uint8, device=device)
    if h == 0:
        return types, filtered
    lib = load_cuda_kernels()
    ptrs = (band.data_ptr(), prev.data_ptr(), filtered.data_ptr())
    _launch(
        lib.filter_select_launch, *ptrs, types.data_ptr(), h, n, bpp,
        int(band.dtype == torch.uint16), filter_variant(n, bpp, *ptrs), _stream(device),
    )
    filter_select.launches += 1
    return types, filtered


filter_select.launches = 0


# --------------------------------------------------------------------------- #
# Positioned alpha compositing
# --------------------------------------------------------------------------- #

# Columns of a segment's meta row (csrc/composite.cuh META_*).
META_COLS = 6
META_Y0, META_X0, META_H, META_W, META_OFFSET, META_STRIDE = range(META_COLS)


def composite_segments_plain(metas: torch.Tensor, srcs: torch.Tensor, bg: Sequence[int],
                             height: int, width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch compositing: a Python loop over the segments that applies
    the exact integer "over" of ``_alpha_over_window_u8``
    (image_stitch_tpu/ops/composite_device.py:50-81) to each window in
    int32. ``metas`` as for ``composite_segments``. Returns (band (height,
    width, 4) uint8, ties () int32)."""
    device = srcs.device
    out = torch.tensor(list(bg), dtype=torch.uint8, device=device).expand(height, width, 4).clone()
    ties = torch.zeros((), dtype=torch.int32, device=device)
    for y0, x0, h, w, offset, stride in metas.tolist():
        if h == 0 or w == 0:
            continue
        s = torch.as_strided(srcs, (h, w, 4), (stride, 4, 1), offset).to(torch.int32)
        window = out[y0 : y0 + h, x0 : x0 + w]
        d = window.to(torch.int32)
        a_s, a_d = s[:, :, 3], d[:, :, 3]
        copy = a_s == 255
        blend = (a_s > 0) & ~copy
        wd = a_d * (255 - a_s)
        den = 255 * a_s + wd
        den_safe = den.clamp(min=1)[:, :, None]
        num = s[:, :, :3] * (255 * a_s)[:, :, None] + d[:, :, :3] * wd[:, :, None]
        q = (2 * num + den_safe) // (2 * den_safe)
        new_a = (2 * den + 255) // 510
        tie = blend & ((2 * num) % (2 * den_safe) == den_safe).any(dim=2)
        rgb = torch.where(copy[:, :, None], s[:, :, :3],
                          torch.where(blend[:, :, None], q, d[:, :, :3]))
        alpha = torch.where(copy, a_s, torch.where(blend, new_a, a_d))
        window.copy_(torch.cat([rgb, alpha[:, :, None]], dim=2).to(torch.uint8))
        ties += tie.sum().to(torch.int32)
    return out, ties


def composite_segments(metas: torch.Tensor, srcs: torch.Tensor, bg: Sequence[int],
                       height: int, width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Blend z-ordered segments (back to front) over a uniform background.

    ``metas`` (S, 6) int64 rows (y0, x0, h, w, byte offset of the first
    pixel in ``srcs``, row stride in bytes), int64 so that ``srcs`` may hold
    2 GiB or more; ``srcs`` the segments' packed
    RGBA uint8 pixels; ``bg`` the background's four values. The metas are
    trusted: the caller keeps every segment inside the (height, width) band
    and its pixels inside ``srcs``. Returns (band (height, width, 4) uint8,
    ties () int32, the count of blends on an exact rational tie). Launches
    csrc/composite.cu for CUDA tensors; the plain version for CPU tensors."""
    device = srcs.device
    _check(metas, "metas", torch.int64, 2, device)
    _check(srcs, "srcs", torch.uint8, 1, device)
    if metas.shape[1] != META_COLS:
        raise ValueError(f"metas: expected (S, {META_COLS}), got {tuple(metas.shape)}")
    bg = tuple(int(v) for v in bg)
    if len(bg) != 4 or not all(0 <= v <= 255 for v in bg):
        raise ValueError(f"bg: expected four values in [0, 255], got {bg}")
    if height < 0 or width < 0:
        raise ValueError(f"band size {height} x {width}")
    if device.type == "cpu":
        return composite_segments_plain(metas, srcs, bg, height, width)
    if device.type != "cuda":
        raise ValueError(f"composite_segments: unsupported device {device}")
    out = torch.empty((height, width, 4), dtype=torch.uint8, device=device)
    ties = torch.zeros((), dtype=torch.int32, device=device)
    if height * width == 0:
        return out, ties
    lib = load_cuda_kernels()
    _launch(
        lib.composite_segments_launch, metas.data_ptr(), metas.shape[0], srcs.data_ptr(),
        bg[0] | bg[1] << 8 | bg[2] << 16 | bg[3] << 24, out.data_ptr(), height, width,
        ties.data_ptr(), _stream(device),
    )
    composite_segments.launches += 1
    return out, ties


composite_segments.launches = 0


# --------------------------------------------------------------------------- #
# JPEG decode: dequantize and IDCT, then upsampling and colour
# --------------------------------------------------------------------------- #

# A job of csrc/idct.cu, one (tile, component) window of a band, is a row of
# the host's job table: first coefficient (in int16 elements), blocks, k,
# quantizer table, blocks a row, first byte of the plane, flags, 0. The
# kernel reads the CTA table made from it (csrc/idct.cuh IDCT_CTA_*), a row
# per CTA of IDCT_CTA_BLOCKS blocks.
IDCT_JOB_COLS = 8
IDCT_CTA_COLS = 8
IDCT_CTA_BLOCKS = 16
# Flag: the column pass is exact in 32 bits, which it is when every
# |coefficient * quantizer| of the job is within IDCT_INT32_MAX_DEQ
# (csrc/idct.cuh proves it).
IDCT_JOB_INT32 = 1
IDCT_INT32_MAX_DEQ = 32767
# A tile of csrc/ycc.cu, one JPEG tile's part of a band: a row of the tile
# table (csrc/ycc.cuh YCC_TILE_*): components, x0, width, variant, four
# unused, then per component 8 values: first byte of its plane, the plane's
# row stride, h_exp, v_exp, r0, w0l, window rows, comp_w.
YCC_TILE_COLS = 32
YCC_TILE_COMP = 8
# The colour kernel's grid is (CTAs of 2 rows down the band, CTAs of 256
# columns across the widest tile, tiles); the last two are 16-bit.
YCC_CTA_COLUMNS = 256
MAX_YCC_TILES = 65535
# How csrc/ycc.cu stores a tile's whole octets of eight pixels, by the variant
# number in the tile's row.
YCC_VARIANTS = ("words", "vec16")

_ZIGZAG = torch.tensor(ZIGZAG, dtype=torch.int64)


def idct_job_table(windows: Sequence[Sequence[int]]) -> torch.Tensor:
    """The job table of ``idct_dequant_batch``, int32 on the CPU.
    ``windows``: per job (first coefficient in int16 elements, blocks, k,
    quantizer table, blocks a row, first byte of the plane, 1 if every
    |coefficient * quantizer| is within ``IDCT_INT32_MAX_DEQ`` else 0)."""
    jobs = np.zeros((len(windows), IDCT_JOB_COLS), dtype=np.int32)
    if len(windows):
        w = np.asarray(windows, dtype=np.int64).reshape(len(windows), 7)
        jobs[:, :6] = w[:, :6]
        jobs[:, 6] = np.where(w[:, 6] != 0, IDCT_JOB_INT32, 0)
    return torch.from_numpy(jobs)


def idct_cta_table(jobs: torch.Tensor) -> torch.Tensor:
    """The table csrc/idct.cu reads, a row per CTA (IDCT_CTA_*): the CTA's
    first coefficient, its live blocks, k, quantizer table, bx, the first
    byte of its first block's block row, that block's place in the row,
    flags. int32 on the CPU; every job's blocks in CTAs of
    ``IDCT_CTA_BLOCKS``, the jobs one after another."""
    rows = jobs.numpy().astype(np.int64)
    off, n, k, qtab, bx, plane, flags = (rows[:, i] for i in range(7))
    per_job = -(-n // IDCT_CTA_BLOCKS)
    job = np.repeat(np.arange(len(rows)), per_job)
    first = np.concatenate([[0], np.cumsum(per_job)[:-1]]) if len(rows) else per_job
    b0 = (np.arange(len(job)) - first[job]) * IDCT_CTA_BLOCKS  # the CTA's first block
    ctas = np.stack([
        off[job] + b0 * k[job], np.minimum(IDCT_CTA_BLOCKS, n[job] - b0), k[job], qtab[job],
        bx[job], plane[job] + b0 // np.maximum(bx[job], 1) * 64 * bx[job],
        b0 % np.maximum(bx[job], 1), flags[job]], axis=1) if len(job) else np.zeros((0, 8))
    return torch.from_numpy(ctas.astype(np.int32))


def ycc_variant(x0: int, out_width: int, address: int) -> int:
    """How csrc/ycc.cu stores the whole octets of a tile at column ``x0`` of a
    band of ``out_width`` columns that starts at ``address``: two 16 B stores
    where every octet lies at a 16 B boundary, else eight 4 B stores. An
    index into ``YCC_VARIANTS``."""
    return int(x0 % 4 == 0 and out_width % 4 == 0 and address % 16 == 0)


def ycc_tile_table(tiles: Sequence[tuple[int, int, Sequence[Sequence[int]]]],
                   out_width: int, address: int) -> torch.Tensor:
    """The tile table of ``ycc_rgba_batch``, int32 on the CPU, for a band of
    ``out_width`` columns at ``address``. ``tiles``: per tile (x0, width,
    components), the components one or three of (first byte of the plane,
    row stride, h_exp, v_exp, r0, w0l, window rows, comp_w)."""
    table = np.zeros((len(tiles), YCC_TILE_COLS), dtype=np.int32)
    for row, (x0, w, comps) in zip(table, tiles):
        row[:4] = (len(comps), x0, w, ycc_variant(x0, out_width, address))
        for i, comp in enumerate(comps[:3]):
            row[YCC_TILE_COMP + 8 * i : YCC_TILE_COMP + 8 * (i + 1)] = comp
    return torch.from_numpy(table)


def _host_table(table: torch.Tensor, name: str, cols: int) -> np.ndarray:
    """The host's table as an int64 array, after checking its form."""
    _check(table, name, torch.int32, 2, torch.device("cpu"))
    if table.shape[1] != cols:
        raise ValueError(f"{name}: expected (n, {cols}), got {tuple(table.shape)}")
    return table.numpy().astype(np.int64)


class StagedTable:
    """A kernel's table that travels to the device inside a larger upload.

    ``source`` is the host table the kernel's wrapper checks (the job table,
    the tile table), ``rows`` the int32 rows the kernel reads, made from it
    here and nowhere else. The object writes its rows into the staging bytes
    (``stage``) and cuts its view out of the uploaded bytes at the same place
    (``bind``), so the rows on the device are the ones made from the table
    that was checked: a wrapper takes a staged table only together with the
    very ``source`` it was made from."""

    def __init__(self, source: torch.Tensor, rows: torch.Tensor):
        self.source = source
        self.rows = rows
        self.device: torch.Tensor | None = None
        self._at: int | None = None

    @classmethod
    def for_idct(cls, jobs: torch.Tensor) -> "StagedTable":
        """The CTA table of ``idct_dequant_batch`` for the job table ``jobs``."""
        return cls(jobs, idct_cta_table(jobs))

    @classmethod
    def for_ycc(cls, tiles: torch.Tensor) -> "StagedTable":
        """The tile table of ``ycc_rgba_batch``, read by the kernel as it is."""
        return cls(tiles, tiles)

    @property
    def nbytes(self) -> int:
        return self.rows.numel() * 4

    def stage(self, staging: np.ndarray, at: int) -> None:
        """Write the rows into the uint8 staging bytes from offset ``at``, a
        multiple of 16."""
        if at % 16:
            raise ValueError(f"a table staged at byte {at}, off a 16 B boundary")
        staging[at : at + self.nbytes] = self.rows.numpy().reshape(-1).view(np.uint8)
        self._at = at

    def bind(self, uploaded: torch.Tensor) -> None:
        """``uploaded``: the staging bytes where the kernel reads them (their
        copy on the device; on the CPU the bytes themselves)."""
        if self._at is None:
            raise ValueError("the table was not staged")
        _check(uploaded, "the uploaded bytes", torch.uint8, 1, uploaded.device)
        if uploaded.numel() < self._at + self.nbytes:
            raise ValueError("the uploaded bytes end before the table")
        self.device = (uploaded[self._at : self._at + self.nbytes]
                       .view(torch.int32).view(self.rows.shape))


def _staged_rows(staged: StagedTable, device: torch.device) -> torch.Tensor:
    """The rows of ``staged`` where the kernel reads them, after checking that
    they were uploaded to ``device``."""
    rows = staged.device
    if rows is None:
        raise ValueError("the staged table was not uploaded")
    _check(rows, "the staged table", torch.int32, 2, device)
    if rows.data_ptr() % 16:
        raise ValueError("the staged table must start at a 16 B boundary")
    return rows


def idct_dequant_batch_plain(coefs: torch.Tensor, qtabs: torch.Tensor, jobs: torch.Tensor,
                             planes: torch.Tensor) -> torch.Tensor:
    """The plain version of ``idct_dequant_batch``: ``decode_plane`` job by
    job."""
    zigzag = _ZIGZAG.to(qtabs.device)
    for off, n, k, qtab, bx, plane, _flags, _ in jobs.tolist():
        q_nat = torch.empty(64, dtype=torch.int32, device=qtabs.device)
        q_nat[zigzag] = qtabs[qtab]
        out = decode_plane(coefs[off : off + n * k].view(n, k), q_nat, bx)
        planes[plane : plane + n * 64] = out.reshape(-1)
    return planes


def idct_dequant_batch(coefs: torch.Tensor, qtabs: torch.Tensor, jobs: torch.Tensor,
                       planes: torch.Tensor,
                       staged: StagedTable | None = None) -> torch.Tensor:
    """Dequantize and inverse-DCT every window of a band in one launch.

    ``coefs`` (N,) int16: the windows' zigzag-prefix coefficients, each
    window's blocks one after another, k a block; ``qtabs`` (T, 64) int32:
    quantizers in zigzag order; ``jobs``: the job table from
    ``idct_job_table``, on the CPU; ``planes`` (P,) uint8: the plane buffer,
    where job j's (blocks / bx * 8, bx * 8) samples go from its plane offset
    on. ``staged``: ``StagedTable.for_idct(jobs)``, uploaded with the
    coefficients; without it the CTA table is made and uploaded here. A job
    flagged ``IDCT_JOB_INT32`` states that its |coefficient * quantizer| stay
    within ``IDCT_INT32_MAX_DEQ``: the card takes its word (reading the
    coefficients back would stall the stream), the CPU path checks it.
    Returns ``planes``. Launches csrc/idct.cu for CUDA tensors;
    ``idct_dequant_batch_plain`` for CPU tensors."""
    device = planes.device
    _check(coefs, "coefs", torch.int16, 1, device)
    _check(qtabs, "qtabs", torch.int32, 2, device)
    _check(planes, "planes", torch.uint8, 1, device)
    if qtabs.shape[1] != 64:
        raise ValueError(f"qtabs: expected (n, 64), got {tuple(qtabs.shape)}")
    if staged is not None and staged.source is not jobs:
        raise ValueError("staged: made from another job table")
    rows = _host_table(jobs, "jobs", IDCT_JOB_COLS)
    off, n, k, qtab, bx, plane = (rows[:, i] for i in range(6))
    if ((k < 8) | (k > 64) | (k % 8 != 0)).any():
        raise ValueError("jobs: k must be a multiple of 8 in [8, 64]")
    if ((n < 1) | (bx < 1) | (n % np.maximum(bx, 1) != 0)).any():
        raise ValueError("jobs: the blocks must be whole rows of bx >= 1")
    if ((off < 0) | (off % 8 != 0) | (off + n * k > coefs.numel())).any():
        raise ValueError("jobs: coefficients outside the buffer or off a 16 B boundary")
    if ((plane < 0) | (plane % 16 != 0) | (plane + n * 64 > planes.numel())).any():
        raise ValueError("jobs: a plane outside the buffer or off a 16 B boundary")
    if ((qtab < 0) | (qtab >= qtabs.shape[0])).any():
        raise ValueError("jobs: a quantizer table that is not there")
    if device.type == "cpu":
        for o, m, kk, t in rows[rows[:, 6] & IDCT_JOB_INT32 != 0, :4].tolist():
            peak = int(coefs[o : o + m * kk].to(torch.int32).abs().max())
            if peak * int(qtabs[t].abs().max()) > IDCT_INT32_MAX_DEQ:
                raise ValueError("jobs: a job flagged for the 32-bit column pass holds "
                                 f"|coefficient * quantizer| past {IDCT_INT32_MAX_DEQ}")
        return idct_dequant_batch_plain(coefs, qtabs, jobs, planes)
    if device.type != "cuda":
        raise ValueError(f"idct_dequant: unsupported device {device}")
    if any(t.data_ptr() % 16 for t in (coefs, qtabs, planes)):
        raise ValueError("coefs, qtabs and planes must start at 16 B boundaries")
    n_ctas = int((-(-n // IDCT_CTA_BLOCKS)).sum())
    if n_ctas == 0:
        return planes
    ctas = (idct_cta_table(jobs).to(device) if staged is None
            else _staged_rows(staged, device))
    lib = load_cuda_kernels()
    _launch(lib.idct_dequant_batch_launch, coefs.data_ptr(), qtabs.data_ptr(), ctas.data_ptr(),
            n_ctas, planes.data_ptr(), _stream(device))
    idct_dequant.launches += 1
    return planes


def idct_dequant(zz: torch.Tensor, q: torch.Tensor, bx: int) -> torch.Tensor:
    """Dequantize and inverse-DCT whole block rows of one component: a
    batch of one window.

    ``zz`` (n, k) int16: each block's first k coefficients in zigzag order
    (the rest zero), n a multiple of ``bx`` blocks a row; ``q`` (64,) int32
    natural-order quantizers. Returns the (n / bx * 8, bx * 8) uint8
    samples, range-limited as libjpeg does. ``idct_dequant.launches`` counts
    the launches of csrc/idct.cu, by this call and by
    ``idct_dequant_batch``."""
    device = zz.device
    _check(zz, "zz", torch.int16, 2, device)
    _check(q, "q", torch.int32, 1, device)
    n, k = zz.shape
    if q.shape[0] != 64:
        raise ValueError(f"q: expected 64 quantizers, got {q.shape[0]}")
    if not 1 <= k <= 64:
        raise ValueError(f"k = {k} outside [1, 64]")
    if bx < 1 or n % bx:
        raise ValueError(f"{n} blocks are not whole rows of {bx}")
    if k % 8:  # coefficients past k are zero: so are the ones padded here
        zz = torch.nn.functional.pad(zz, (0, -k % 8))
    out = torch.empty(n * 64, dtype=torch.uint8, device=device)
    if n:
        narrow = (int(zz.to(torch.int32).abs().max()) * int(q.abs().max())
                  <= IDCT_INT32_MAX_DEQ)
        jobs = idct_job_table([(0, n, zz.shape[1], 0, bx, 0, narrow)])
        idct_dequant_batch(zz.reshape(-1), q[_ZIGZAG.to(device)].view(1, 64), jobs, out)
    return out.view(n // bx * 8, bx * 8)


idct_dequant.launches = 0


def ycc_rgba_batch_plain(planes: torch.Tensor, tiles: torch.Tensor,
                         out: torch.Tensor) -> torch.Tensor:
    """The plain version of ``ycc_rgba_batch``: ``window_to_rgba`` tile by
    tile, each plane a 2-D view of the plane buffer."""
    for row in tiles.tolist():
        n_comp, x0, w = row[:3]
        views, geoms = [], []
        for i in range(n_comp):
            plane, stride, h_exp, v_exp, r0, w0l, hw, comp_w = (
                row[YCC_TILE_COMP + 8 * i : YCC_TILE_COMP + 8 * (i + 1)])
            views.append(planes[plane : plane + (w0l + hw) * stride].view(w0l + hw, stride))
            geoms.append((h_exp, v_exp, r0, w0l, w0l + hw, comp_w))
        out[:, x0 : x0 + w] = window_to_rgba(views, geoms, out.shape[0], w)
    return out


def ycc_rgba_batch(planes: torch.Tensor, tiles: torch.Tensor, out: torch.Tensor,
                   staged: StagedTable | None = None) -> torch.Tensor:
    """Crop, upsample and colour-convert every tile of a band in one launch.

    ``planes`` (P,) uint8: the band's plane buffer, as ``idct_dequant_batch``
    fills it; ``tiles``: the tile table from ``ycc_tile_table``, on the CPU;
    ``out``: the (h, W, 4) uint8 band, whose columns [x0, x0 + width) get
    each tile's RGBA, alpha 255. ``staged``: ``StagedTable.for_ycc(tiles)``,
    uploaded with the planes' coefficients; without it the table is uploaded
    here. Returns ``out``. Launches
    csrc/ycc.cu for CUDA tensors; ``ycc_rgba_batch_plain`` for CPU
    tensors."""
    device = out.device
    _check(out, "out", torch.uint8, 3, device)
    _check(planes, "planes", torch.uint8, 1, device)
    h, w_out, c = out.shape
    if c != 4:
        raise ValueError(f"out: expected (h, W, 4), got {tuple(out.shape)}")
    if staged is not None and staged.source is not tiles:
        raise ValueError("staged: made from another tile table")
    rows = _host_table(tiles, "tiles", YCC_TILE_COLS)
    n_comp, x0, w, variant = rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3]
    if (~np.isin(n_comp, (1, 3))).any():
        raise ValueError("tiles: expected 1 or 3 components")
    if ((x0 < 0) | (w < 0) | (x0 + w > w_out)).any():
        raise ValueError(f"tiles: columns outside the band's {w_out}")
    vec16 = variant == 1
    if (~np.isin(variant, (0, 1))).any() or (
            vec16.any() and (w_out % 4 or out.data_ptr() % 16 or (x0[vec16] % 4).any())):
        raise ValueError("tiles: a store variant the band or the tile's x0 does not allow")
    for i in range(3):
        live = n_comp > i
        plane, stride, h_exp, v_exp, r0, w0l, hw, comp_w = (
            rows[live, YCC_TILE_COMP + 8 * i + j] for j in range(8))
        if ((h_exp < 1) | (v_exp < 1) | (r0 < 0) | (w0l < 0) | (hw < 0) | (comp_w < 1)
                | (stride < comp_w) | (hw * v_exp < r0 + h) | (comp_w * h_exp < w[live])
                | (plane < 0) | (plane + (w0l + hw) * stride > planes.numel())).any():
            raise ValueError(f"tiles: a window of component {i} does not cover its tile's "
                             f"{h} rows, or lies outside the plane buffer")
    if device.type == "cpu":
        return ycc_rgba_batch_plain(planes, tiles, out)
    if device.type != "cuda":
        raise ValueError(f"ycc_rgba: unsupported device {device}")
    max_w = int(w.max()) if len(w) else 0
    if len(w) > MAX_YCC_TILES or max_w > MAX_YCC_TILES * YCC_CTA_COLUMNS:
        raise ValueError(f"{len(w)} tiles up to {max_w} columns wide: the kernel's grid takes "
                         f"{MAX_YCC_TILES} tiles of {MAX_YCC_TILES * YCC_CTA_COLUMNS} columns")
    if h == 0 or max_w == 0:
        return out
    dev_tiles = tiles.to(device) if staged is None else _staged_rows(staged, device)
    lib = load_cuda_kernels()
    _launch(lib.ycc_rgba_batch_launch, planes.data_ptr(), dev_tiles.data_ptr(), len(w), max_w,
            out.data_ptr(), w_out * 4, h, _stream(device))
    ycc_rgba.launches += 1
    return out


def ycc_rgba(planes: Sequence[torch.Tensor], geoms: Sequence[tuple[int, ...]],
             out: torch.Tensor, x0: int, width: int) -> torch.Tensor:
    """Crop, upsample and colour-convert one tile's band into ``out``: a
    batch of one tile.

    ``planes``: one (gray) or three uint8 planes from ``idct_dequant``;
    ``geoms``: per plane (h_exp, v_exp, r0, w0l, w1l, comp_w), its window
    being rows [w0l, w1l) and columns [0, comp_w), and the band's first row
    its upsampled row r0; ``out``: the (h, W, 4) uint8 band, whose columns
    [x0, x0 + width) get the tile's RGBA, alpha 255. Returns ``out``.
    ``ycc_rgba.launches`` counts the launches of csrc/ycc.cu, by this call
    and by ``ycc_rgba_batch``."""
    device = out.device
    _check(out, "out", torch.uint8, 3, device)
    h, w_out, c = out.shape
    if c != 4:
        raise ValueError(f"out: expected (h, W, 4), got {tuple(out.shape)}")
    if len(planes) not in (1, 3) or len(geoms) != len(planes):
        raise ValueError(f"expected 1 or 3 planes with a geometry each, got "
                         f"{len(planes)} and {len(geoms)}")
    if not (0 <= x0 and width >= 0 and x0 + width <= w_out):
        raise ValueError(f"columns [{x0}, {x0 + width}) outside the band's {w_out}")
    comps, parts, at = [], [], 0
    for plane, geom in zip(planes, geoms):
        _check(plane, "plane", torch.uint8, 2, device)
        h_exp, v_exp, r0, w0l, w1l, comp_w = (int(g) for g in geom)
        if (h_exp < 1 or v_exp < 1 or not 0 <= w0l <= w1l <= plane.shape[0]
                or not 0 < comp_w <= plane.shape[1] or r0 < 0
                or (w1l - w0l) * v_exp < r0 + h or comp_w * h_exp < width):
            raise ValueError(f"window {geom} does not cover {h} x {width} of a plane of "
                             f"{tuple(plane.shape)}")
        comps.append((at, plane.shape[1], h_exp, v_exp, r0, w0l, w1l - w0l, comp_w))
        parts.append(torch.nn.functional.pad(plane.reshape(-1), (0, -plane.numel() % 16)))
        at += parts[-1].numel()
    tiles = ycc_tile_table([(x0, width, comps)], w_out, out.data_ptr())
    return ycc_rgba_batch(torch.cat(parts), tiles, out)


ycc_rgba.launches = 0


# --------------------------------------------------------------------------- #
# JPEG encode: colour, forward DCT and quantization; symbol streams
# --------------------------------------------------------------------------- #


# The kernels of csrc/fdct_quant.cu, by the variant number its launcher
# takes: how a thread loads its 8 pixels.
FDCT_VARIANTS = ("bytes", "rgb_vec8", "rgba_vec16")


def fdct_variant(ch: int, address: int) -> int:
    """The csrc/fdct_quant.cu kernel for a band of ``ch`` bytes a pixel that
    starts at ``address`` (its rows are whole blocks of 8 pixels, so they
    keep the band's alignment): two 16 B loads per 8 pixels for RGBA at a
    16 B boundary, three 8 B loads for RGB at an 8 B boundary, else byte
    loads. An index into ``FDCT_VARIANTS``."""
    if ch == 4 and address % 16 == 0:
        return 2
    if ch == 3 and address % 8 == 0:
        return 1
    return 0


def fdct_quant(band: torch.Tensor, luma_q: torch.Tensor, chroma_q: torch.Tensor,
               sampling: str = "444"):
    """YCbCr, forward DCT and quantization of an (H, W, C >= 3) uint8 band,
    read with its pixel stride C. 4:4:4: H and W multiples of 8; returns
    (y, cb, cr), each (H/8 * W/8, 64) int16 natural-order blocks,
    strip-major. 4:2:0: H and W multiples of 16; returns y (4n, 64) in MCU
    order [TL, TR, BL, BR] and cb, cr (n, 64), n MCUs raster-major.
    Launches csrc/fdct_quant.cu for CUDA tensors;
    ``jpeg_dct.band_to_blocks_islow`` (or ``_420``) for CPU tensors."""
    device = band.device
    if band.dtype != torch.uint8 or band.ndim != 3 or band.shape[2] < 3:
        raise TypeError(f"band: expected an (H, W, C >= 3) uint8 tensor, got "
                        f"{tuple(band.shape)} {band.dtype}")
    if not band.is_contiguous():
        raise ValueError("band: must be contiguous")
    _check(luma_q, "luma_q", torch.int32, 1, device)
    _check(chroma_q, "chroma_q", torch.int32, 1, device)
    if luma_q.shape[0] != 64 or chroma_q.shape[0] != 64:
        raise ValueError("quantization tables must hold 64 values")
    if sampling not in ("444", "420"):
        raise ValueError(f"unsupported sampling {sampling!r}")
    h, w, ch = band.shape
    m = 16 if sampling == "420" else 8
    if h % m or w % m:
        raise ValueError(f"band {h} x {w}: rows and columns must be multiples of {m}")
    if device.type == "cpu":
        fn = band_to_blocks_islow_420 if sampling == "420" else band_to_blocks_islow
        return fn(band, luma_q, chroma_q)
    if device.type != "cuda":
        raise ValueError(f"fdct_quant: unsupported device {device}")
    n = (h // 8) * (w // 8)
    n_c = n // 4 if sampling == "420" else n
    blocks = [torch.empty((cnt, 64), dtype=torch.int16, device=device) for cnt in (n, n_c, n_c)]
    if n == 0:
        return tuple(blocks)
    lib = load_cuda_kernels()
    _launch(lib.fdct_quant_launch, band.data_ptr(), h, w, ch, luma_q.data_ptr(),
            chroma_q.data_ptr(), int(sampling == "420"), fdct_variant(ch, band.data_ptr()),
            *(b.data_ptr() for b in blocks), _stream(device))
    fdct_quant.launches += 1
    return tuple(blocks)


fdct_quant.launches = 0

# Words of the packed symbol table (csrc/symbols.cuh SYM_LUT_WORDS).
SYMBOL_LUT_WORDS = 1096
SYMBOL_SLOTS = 65


def symbol_streams(yb: torch.Tensor, cbb: torch.Tensor, crb: torch.Tensor, luts: dict,
                   n_groups: int = 1, sampling: str = "444",
                   prev_dc: torch.Tensor | None = None):
    """Huffman (code, length) slots of quantized blocks in MCU order.

    ``yb``, ``cbb``, ``crb``: (n, 64) int16 natural-order blocks (4n luma
    blocks for 4:2:0); ``luts``: ``jpeg_entropy_device.build_entropy_luts``;
    the DC chains restart from 0 at each of ``n_groups`` equal restart
    groups, or, given ``prev_dc`` ((3,) int32, one group), continue from it.
    Returns (codes, lens, block_bits, last_dc): codes and lens (B, 65) int32
    (DC, 63 AC positions, EOB); block_bits (B,) int32, each block's lengths
    summed; last_dc (3,) int32, the DC of each component's last block.
    Launches csrc/symbols.cu for CUDA tensors;
    ``jpeg_entropy_device.symbol_streams_plain`` for CPU tensors."""
    device = yb.device
    for name, t in (("yb", yb), ("cbb", cbb), ("crb", crb)):
        _check(t, name, torch.int16, 2, device)
        if t.shape[1] != 64:
            raise ValueError(f"{name}: expected (n, 64), got {tuple(t.shape)}")
    n = cbb.shape[0]
    luma = 4 if sampling == "420" else 1
    if sampling not in ("444", "420"):
        raise ValueError(f"unsupported sampling {sampling!r}")
    if yb.shape[0] != luma * n or crb.shape[0] != n:
        raise ValueError(f"block counts {yb.shape[0]}, {n}, {crb.shape[0]} do not make "
                         f"{sampling} MCUs")
    if n < 1 or n_groups < 1 or n % n_groups:
        raise ValueError(f"{n} MCUs do not make {n_groups} equal restart groups")
    if prev_dc is not None:
        _check(prev_dc, "prev_dc", torch.int32, 1, device)
        if prev_dc.shape[0] != 3 or n_groups != 1:
            raise ValueError("prev_dc: three predictors, for one carried group")
    if device.type == "cpu":
        from .jpeg_entropy_device import symbol_streams_plain

        codes, lens = symbol_streams_plain(yb, cbb, crb, luts, n_groups, sampling, prev_dc)
        last_dc = torch.stack([c[-1, 0].to(torch.int32) for c in (yb, cbb, crb)])
        return codes, lens, lens.sum(dim=1, dtype=torch.int32), last_dc
    if device.type != "cuda":
        raise ValueError(f"symbol_streams: unsupported device {device}")
    packed = luts["packed"]
    _check(packed, "luts['packed']", torch.int32, 1, device)
    if packed.shape[0] != SYMBOL_LUT_WORDS:
        raise ValueError(f"luts['packed']: expected {SYMBOL_LUT_WORDS} words")
    n_blocks = n * (luma + 2)
    codes = torch.empty((n_blocks, SYMBOL_SLOTS), dtype=torch.int32, device=device)
    lens = torch.empty((n_blocks, SYMBOL_SLOTS), dtype=torch.int32, device=device)
    block_bits = torch.empty(n_blocks, dtype=torch.int32, device=device)
    last_dc = torch.empty(3, dtype=torch.int32, device=device)
    lib = load_cuda_kernels()
    _launch(lib.symbol_streams_launch, yb.data_ptr(), cbb.data_ptr(), crb.data_ptr(), n,
            int(sampling == "420"), n_groups, 0 if prev_dc is None else prev_dc.data_ptr(),
            packed.data_ptr(), codes.data_ptr(), lens.data_ptr(), block_bits.data_ptr(),
            last_dc.data_ptr(), _stream(device))
    symbol_streams.launches += 1
    return codes, lens, block_bits, last_dc


symbol_streams.launches = 0

# Blocks of one CTA of csrc/layout.cu (csrc/layout.cuh LAYOUT_CHUNK).
LAYOUT_CHUNK = 1024
# The layout kernel's scratch buffers, one per (card, stream): zeroed once,
# when made; see csrc/layout.cu.
_layout_scratch: dict[tuple[int, int], torch.Tensor] = {}


def _layout_scratch_for(device: torch.device, stream: int,
                        n_chunks: int) -> tuple[torch.Tensor, int]:
    """The (scratch, capacity in chunks) of ``stream``, grown to hold
    ``n_chunks``. A buffer that is too small is dropped for a new, zeroed
    one: the launches that used it lie before on the same stream."""
    key = (device.index, stream)
    scratch = _layout_scratch.get(key)
    if scratch is None or (scratch.numel() - 2) // 4 < n_chunks:
        cap = max(1024, 1 << (n_chunks - 1).bit_length())
        scratch = torch.zeros(2 + 4 * cap, dtype=torch.int32, device=device)
        _layout_scratch[key] = scratch
    return scratch, (scratch.numel() - 2) // 4


def group_layout(block_bits: torch.Tensor, n_groups: int = 1,
                 bit_base: torch.Tensor | None = None):
    """Where each block starts in the packed stream, from the blocks' bit
    counts.

    ``block_bits`` (B,) int32 makes ``n_groups`` equal restart groups, group
    g starting at word sum(ceil(group_bits[h] / 32) for h < g), its blocks
    one after another; or, given ``bit_base`` (() int64 on the device, one
    group), the carried stream, which starts at that bit. Returns (starts
    (B,) int32 global start bits, group_bits (n_groups,) int32,
    max_block_bits () int32, total_bits () int64 with ``bit_base``,
    next_base () int64 = total_bits % 8); the last two are None without
    ``bit_base``. Launches csrc/layout.cu for CUDA tensors, reading
    ``bit_base`` on the card; ``jpeg_entropy_device.group_layout_plain`` for
    CPU tensors."""
    device = block_bits.device
    _check(block_bits, "block_bits", torch.int32, 1, device)
    n_blocks = block_bits.shape[0]
    if n_blocks < 1 or n_groups < 1 or n_blocks % n_groups:
        raise ValueError(f"{n_blocks} blocks do not make {n_groups} equal restart groups")
    if bit_base is not None:
        _check(bit_base, "bit_base", torch.int64, 0, device)
        if n_groups != 1:
            raise ValueError("bit_base: for one carried group")
    if device.type == "cpu":
        from .jpeg_entropy_device import group_layout_plain

        return group_layout_plain(block_bits, n_groups, bit_base)
    if device.type != "cuda":
        raise ValueError(f"group_layout: unsupported device {device}")
    starts = torch.empty(n_blocks, dtype=torch.int32, device=device)
    group_bits = torch.empty(n_groups, dtype=torch.int32, device=device)
    max_bits = torch.empty((), dtype=torch.int32, device=device)
    totals = None if bit_base is None else torch.empty(2, dtype=torch.int64, device=device)
    stream = _stream(device)
    n_chunks = n_groups * -(-(n_blocks // n_groups) // LAYOUT_CHUNK)
    scratch, cap = _layout_scratch_for(device, stream, n_chunks)
    lib = load_cuda_kernels()
    _launch(lib.group_layout_launch, block_bits.data_ptr(), n_blocks, n_groups,
            0 if bit_base is None else bit_base.data_ptr(), scratch.data_ptr(), cap,
            starts.data_ptr(), group_bits.data_ptr(), max_bits.data_ptr(),
            0 if totals is None else totals.data_ptr(), stream)
    group_layout.launches += 1
    if totals is None:
        return starts, group_bits, max_bits, None, None
    return starts, group_bits, max_bits, totals[0], totals[1]


group_layout.launches = 0


# --------------------------------------------------------------------------- #
# The fused uniform-grid step
# --------------------------------------------------------------------------- #

# How csrc/grid_dual.cu reads the tile stack, by the variant number its
# launcher takes: 4 B or 16 B copies. "composition" is the step the kernel
# replaces, which launches no grid_dual: the rows assembled by a copy, then
# filter_select and fdct_quant.
GRID_DUAL_VARIANTS = ("composition", "words", "vec16")


def grid_dual_variant(tw: int, *addresses: int) -> int:
    """The csrc/grid_dual.cu kernel for tiles ``tw`` pixels wide whose tile
    stack and carry row start at ``addresses``: 16 B copies where a tile
    row's bytes and the addresses are multiples of 16, 4 B copies where the
    addresses are multiples of 4, and else the composition. An index into
    ``GRID_DUAL_VARIANTS``."""
    if any(a % 4 for a in addresses):
        return 0
    return 2 if tw % 4 == 0 and not any(a % 16 for a in addresses) else 1


# CTAs across a strip of 8 canvas rows, and the fewest pixels each takes
# where the width allows (csrc/grid_dual.cuh GRID_DUAL_MAX_CTAS,
# GRID_DUAL_MIN_CHUNK_PX).
GRID_DUAL_MAX_CTAS = 8
GRID_DUAL_MIN_CHUNK_PX = 128
# Words of each CTA's sums in the exchange (GRID_DUAL_SUMS): 8 rows x 5.
GRID_DUAL_SUMS = 40


def grid_dual_ctas(rows: int, w: int) -> int:
    """CTAs of a csrc/grid_dual.cu launch over ``rows`` canvas rows of ``w``
    pixels: per 8-row strip, chunks of a multiple of 8 pixels, at most
    GRID_DUAL_MAX_CTAS of them and each of GRID_DUAL_MIN_CHUNK_PX pixels or
    more where the width allows (csrc/grid_dual.cuh grid_dual_split)."""
    groups = -(-w // 8)
    k = min(GRID_DUAL_MAX_CTAS, max(1, -(-groups // (GRID_DUAL_MIN_CHUNK_PX // 8))))
    chunk = -(-groups // k) * 8
    return -(-rows // 8) * -(-w // chunk)


# The exchange between a strip's CTAs of csrc/grid_dual.cu, one per (card,
# stream): [scratch, its capacity in CTAs, tickets taken, last flag value].
# Zeroed once, when made; see csrc/grid_dual.cu.
_grid_scratch: dict[tuple[int, int], list] = {}


def _grid_scratch_for(device: torch.device, stream: int, n_ctas: int) -> list:
    """The exchange of ``stream``, grown to hold ``n_ctas``: a buffer that is
    too small, or whose flag values are spent, is dropped for a new, zeroed
    one (the launches that used it lie before on the same stream)."""
    key = (device.index, stream)
    state = _grid_scratch.get(key)
    if state is None or state[1] < n_ctas or state[3] >= MASK32:
        cap = max(1024, 1 << (n_ctas - 1).bit_length())
        scratch = torch.zeros(2 + cap * (1 + GRID_DUAL_SUMS), dtype=torch.int32, device=device)
        state = _grid_scratch[key] = [scratch, cap, 0, 0]
    return state


def grid_rows(tiles: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Canvas rows [lo, hi) of a (gy, gx, th, tw, C) tile stack as a
    (hi - lo, gx * tw, C) tensor: a copy of the tile rows that hold them."""
    gy, gx, th, tw, c = tiles.shape
    if hi <= lo:
        return tiles.new_empty((0, gx * tw, c))
    t0, t1 = lo // th, -(-hi // th)
    band = tiles[t0:t1].permute(0, 2, 1, 3, 4).reshape((t1 - t0) * th, gx * tw, c)
    return band[lo - t0 * th:hi - t0 * th]


def _grid_dual_composed(tiles, prev_row, luma_q, chroma_q, r0, r1, png, jpeg, select,
                        quantize) -> tuple:
    """Rows [r0, r1) of the tile stack assembled with the row above them,
    then ``select`` (filter select, bpp 4) and ``quantize`` (4:4:4)."""
    lo = max(r0 - 1, 0)
    rows = grid_rows(tiles, lo, r1)
    band = rows[r0 - lo:]
    n = tiles.shape[1] * tiles.shape[3] * 4
    out = []
    if png:
        prev = prev_row if r0 == 0 else rows[0].reshape(n)
        if r1 == r0:
            out += [torch.empty(0, dtype=torch.int32, device=tiles.device),
                    tiles.new_empty((0, n)), prev]
        else:
            raw = band.reshape(r1 - r0, n)
            types, filtered = select(raw.contiguous(), prev.contiguous(), 4)
            out += [types.to(torch.int32), filtered, raw[-1]]
    if jpeg:
        if r1 == r0:
            out += [torch.empty((0, 64), dtype=torch.int16, device=tiles.device)
                    for _ in range(3)]
        else:
            out += list(quantize(band.contiguous(), luma_q, chroma_q))
    return tuple(out)


def grid_dual_plain(tiles: torch.Tensor, prev_row, luma_q, chroma_q, r0: int, r1: int,
                    png: bool = True, jpeg: bool = True) -> tuple:
    """Plain torch version of ``grid_dual``: the rows assembled, then
    ``filter_select_plain`` and ``jpeg_dct.band_to_blocks_islow``."""
    return _grid_dual_composed(tiles, prev_row, luma_q, chroma_q, r0, r1, png, jpeg,
                               filter_select_plain, band_to_blocks_islow)


def grid_dual_composed(tiles: torch.Tensor, prev_row, luma_q, chroma_q, r0: int, r1: int,
                       png: bool = True, jpeg: bool = True) -> tuple:
    """The step that ``grid_dual`` replaces: the rows assembled by a copy,
    then the ``filter_select`` and ``fdct_quant`` wrappers (their kernels on
    CUDA tensors, their plain versions on CPU tensors)."""
    return _grid_dual_composed(tiles, prev_row, luma_q, chroma_q, r0, r1, png, jpeg,
                               filter_select, fdct_quant)


def grid_dual(tiles: torch.Tensor, prev_row, luma_q, chroma_q, r0: int = 0,
              r1: int | None = None, png: bool = True, jpeg: bool = True) -> tuple:
    """The fused uniform-grid step over canvas rows [r0, r1) (all rows by
    default) of a (gy, gx, th, tw, 4) uint8 tile stack, read in place:
    canvas pixel (r, x) is tiles[r // th, x // tw, r % th, x % tw].

    With ``png``: the filter select of the rows at bpp 4 after the row above
    them (``prev_row``, the (gx * tw * 4,) uint8 carry, for r0 = 0; canvas
    row r0 - 1 otherwise, and ``prev_row`` may be None), giving types
    (rows,) int32, filtered (rows, W * 4) uint8 and the raw row r1 - 1
    (W * 4,) (the row above for an empty range). With ``jpeg`` (rows and W
    multiples of 8): y, cb, cr (rows / 8 * W / 8, 64) int16 4:4:4 blocks,
    strip-major, from the (64,) int32 tables. Returns the PNG outputs, then
    the JPEG ones.

    Launches csrc/grid_dual.cu once for CUDA tensors (the variant that
    ``grid_dual_variant`` picks; where it picks "composition",
    ``grid_dual_composed``, which launches filter_select and fdct_quant, and
    no launch for an empty range); ``grid_dual_plain`` for CPU tensors."""
    device = tiles.device
    if tiles.dtype != torch.uint8 or tiles.ndim != 5 or tiles.shape[4] != 4:
        raise TypeError(f"tiles: expected a (gy, gx, th, tw, 4) uint8 tensor, got "
                        f"{tuple(tiles.shape)} {tiles.dtype}")
    if not tiles.is_contiguous():
        raise ValueError("tiles: must be contiguous")
    gy, gx, th, tw, _ = tiles.shape
    h, w = gy * th, gx * tw
    r1 = h if r1 is None else r1
    if not 0 <= r0 <= r1 <= h:
        raise ValueError(f"rows [{r0}, {r1}) outside the canvas's {h}")
    if not (png or jpeg):
        raise ValueError("grid_dual: neither the PNG nor the JPEG half asked for")
    if png:
        if w * 4 >= MAX_FILTER_ROW:
            raise ValueError(f"rows of {w * 4} bytes: the kernel takes fewer than "
                             f"{MAX_FILTER_ROW}")
        if r0 == 0:
            _check(prev_row, "prev_row", torch.uint8, 1, device)
            if prev_row.shape[0] != w * 4:
                raise ValueError(f"prev_row has {prev_row.shape[0]} bytes, the rows {w * 4}")
    if jpeg:
        _check(luma_q, "luma_q", torch.int32, 1, device)
        _check(chroma_q, "chroma_q", torch.int32, 1, device)
        if luma_q.shape[0] != 64 or chroma_q.shape[0] != 64:
            raise ValueError("quantization tables must hold 64 values")
        if (r1 - r0) % 8 or w % 8:
            raise ValueError(f"{r1 - r0} x {w}: the JPEG half takes multiples of 8")
    if device.type == "cpu":
        return grid_dual_plain(tiles, prev_row, luma_q, chroma_q, r0, r1, png, jpeg)
    if device.type != "cuda":
        raise ValueError(f"grid_dual: unsupported device {device}")
    if r1 == r0:
        return grid_dual_plain(tiles, prev_row, luma_q, chroma_q, r0, r1, png, jpeg)
    prev_used = png and r0 == 0
    variant = grid_dual_variant(tw, tiles.data_ptr(), *([prev_row.data_ptr()] if prev_used else []))
    if variant == 0:
        return grid_dual_composed(tiles, prev_row, luma_q, chroma_q, r0, r1, png, jpeg)
    rows = r1 - r0
    out: list[torch.Tensor] = []
    ptrs = [0] * 6
    if png:
        out += [torch.empty(rows, dtype=torch.int32, device=device),
                torch.empty((rows, w * 4), dtype=torch.uint8, device=device),
                torch.empty(w * 4, dtype=torch.uint8, device=device)]
        ptrs[:3] = [t.data_ptr() for t in out[:3]]
    if jpeg:
        n = rows // 8 * (w // 8)
        blocks = [torch.empty((n, 64), dtype=torch.int16, device=device) for _ in range(3)]
        out += blocks
        ptrs[3:] = [t.data_ptr() for t in blocks]
    lib = load_cuda_kernels()
    stream = _stream(device)
    n_ctas = grid_dual_ctas(rows, w)
    exchange = _grid_scratch_for(device, stream, n_ctas) if png else [None, 0, 0, 0]
    _launch(lib.grid_dual_launch, tiles.data_ptr(), prev_row.data_ptr() if prev_used else 0,
            gx, th, tw, r0, r1, luma_q.data_ptr() if jpeg else 0,
            chroma_q.data_ptr() if jpeg else 0, int(png), int(jpeg), variant, *ptrs,
            0 if exchange[0] is None else exchange[0].data_ptr(), exchange[1], exchange[2],
            exchange[3] + 1, stream)
    if png:
        exchange[2] += n_ctas
        exchange[3] += 1
    grid_dual.launches += 1
    return tuple(out)


grid_dual.launches = 0
