"""Hand-written Hopper kernels of the JPEG entropy stage, with their plain
torch versions.

``pack_blocks_aligned`` (csrc/pack.cu) replaces the Pallas kernel
``image_stitch_tpu/ops/pallas_kernels.py::_pack_kernel``; ``merge_or``
(csrc/merge.cu) replaces ``jpeg_entropy_device.py::_merge_aligned_hybrid``.
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

import torch

from .._build import load_cuda_kernels

MASK32 = 0xFFFFFFFF
# Largest words-per-block the kernels take (csrc/pack.cuh PACK_MAX_AW).
MAX_AW = 32


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
# Phase 1: pack
# --------------------------------------------------------------------------- #


def pack_blocks_aligned_plain(codes: torch.Tensor, lens: torch.Tensor,
                              starts: torch.Tensor, local_words: int) -> torch.Tensor:
    """Plain torch phase-1 pack, the same arithmetic as csrc/pack.cuh.

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


def pack_blocks_aligned(codes: torch.Tensor, lens: torch.Tensor,
                        starts: torch.Tensor, local_words: int) -> torch.Tensor:
    """Phase-1 pack: (nb, n_sym) int32 symbol streams and (nb,) int32 start
    bits -> (nb, local_words + 2) int32 pre-aligned words. Launches
    csrc/pack.cu for CUDA tensors; the plain version for CPU tensors."""
    nb, n_sym = codes.shape
    device = codes.device
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
    if device.type == "cpu":
        return pack_blocks_aligned_plain(codes, lens, starts, local_words)
    if device.type != "cuda":
        raise ValueError(f"pack_blocks_aligned: unsupported device {device}")
    out = torch.empty((nb, n_aw), dtype=torch.int32, device=device)
    if nb == 0:
        return out
    lib = load_cuda_kernels()
    _launch(
        lib.pack_blocks_aligned_launch, codes.data_ptr(), lens.data_ptr(),
        starts.data_ptr(), out.data_ptr(), nb, n_sym, n_aw, _stream(device),
    )
    pack_blocks_aligned.launches += 1
    return out


pack_blocks_aligned.launches = 0


# --------------------------------------------------------------------------- #
# Phase 2: merge
# --------------------------------------------------------------------------- #


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


def merge_or(local: torch.Tensor, starts: torch.Tensor, n_words: int) -> torch.Tensor:
    """Phase-2 merge: OR each block's (nb, n_aw) pre-aligned words into a
    zeroed (n_words,) int32 stream at ``(starts >> 5) + c``. Launches
    csrc/merge.cu for CUDA tensors; the plain version for CPU tensors."""
    device = local.device
    _check(local, "local", torch.int32, 2, device)
    _check(starts, "starts", torch.int32, 1, device)
    nb, n_aw = local.shape
    if starts.shape[0] != nb:
        raise ValueError(f"starts has {starts.shape[0]} blocks, local {nb}")
    if n_words < 0:
        raise ValueError(f"n_words = {n_words} < 0")
    if device.type == "cpu":
        return merge_or_plain(local, starts, n_words)
    if device.type != "cuda":
        raise ValueError(f"merge_or: unsupported device {device}")
    dense = torch.zeros(n_words, dtype=torch.int32, device=device)
    if nb == 0 or n_words == 0:
        return dense
    lib = load_cuda_kernels()
    _launch(
        lib.merge_or_launch, local.data_ptr(), starts.data_ptr(),
        dense.data_ptr(), nb, n_aw, n_words, _stream(device),
    )
    merge_or.launches += 1
    return dense


merge_or.launches = 0
