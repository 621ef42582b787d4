"""JPEG entropy coding on the device, in torch: symbol streams, the
pack-and-merge kernel, and the streaming band encoder.

Port of ``image_stitch_tpu/ops/jpeg_entropy_device.py``. Per band:

1. ``_symbol_streams_flat`` (restart groups, DC chains reset at each group)
   or ``_symbol_streams`` (one carried stream, DC carried in ``prev_dc``)
   turn quantized blocks into (B, 65) Huffman (code, length) slots: DC,
   63 AC positions, EOB, through ``kernels.symbol_streams``
   (csrc/symbols.cu). Its plain version, ``symbol_streams_plain``: a
   gather for the zigzag order, a ``cummax`` for run lengths, LUT gathers
   for the codes.
2. ``kernels.group_layout`` (csrc/layout.cu) turns the blocks' bit counts,
   which the symbol kernel gives, into each block's global start bit, the
   groups' bit counts, the largest block and the carried stream's total.
   Its plain version, ``group_layout_plain``: sums and cumulative sums.
3. ``pack_merge`` (csrc/pack_merge.cu) packs each block's slots into
   words pre-aligned to the block's global start bit and adds them into
   the dense stream, in one launch.

``pack_groups_from_blocks`` lays restart groups out densely (group g at
word cumsum(ceil(bits/32))[g]); ``entropy_pack_carried`` packs one stream
that starts at ``bit_base``. ``TorchJpegEncoder`` drives them band by band:
``submit`` queues device work and never waits for it; ``wait`` reads the
results back, adds 0xFF stuffing, RST markers and the sub-byte carry, and
codes a band on the host, exactly, when it overflows every device budget.
With a ``mesh`` (the counterpart of ``DeviceJpegEncoder(mesh=)``) a band's
whole restart groups are dealt over the mesh's shards by ``row_slabs``,
each shard's slab packed on its own device and stream; the handles stay in
row order, so the markers and the bytes are those of one device.

Bit words are int32 tensors holding uint32 bit patterns (see
ops/kernels.py). Symbol codes are below 2^27 and fit int32 as they are.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Mapping

import numpy as np
import torch

from ..codecs.jpeg.huffman import BitPacker, HuffmanEncoder, interleave_mcus
from ..codecs.jpeg.tables import ZIGZAG, huffman_lut
from ..parallel.mesh import Mesh, ShardedBand, band_rows, row_slabs
from ..utils.observability import span
from .counters import EncodeCounters
from .device import jpeg_quantize, jpeg_quantize_420
from .kernels import group_layout, pack_merge, stream_fits_int32, symbol_streams
from .resolve import resolve_device
from .staging import BandStaging

# Packed-output budget in bits per pixel before the first band reports,
# and its ceiling (the JAX package's values).
DEFAULT_CAP_BITS_PER_PX = 3
MAX_CAP_BITS_PER_PX = 12
# Largest per-block word budget (768 bits per block).
LOCAL_WORDS = 24


def _to_int32(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.size and (a.min() < -(1 << 31) or a.max() >= (1 << 31)):
        raise ValueError("table value outside int32")
    return torch.from_numpy(a.astype(np.int32)).to(device)


def entropy_luts_from_numpy(luts: Mapping[str, np.ndarray], device) -> dict:
    """State converter: a LUT dict of numpy arrays (the JAX package's
    ``build_entropy_luts`` output, fetched to the host) -> the port's int32
    tensors on ``device``. Any further arrays in ``luts``, such as the
    quality-scaled quant tables, are converted the same way. The port's
    dict also carries the zigzag scan order, so that the symbol stage makes
    no host-to-device copy per band."""
    out = {k: _to_int32(v, device) for k, v in luts.items()}
    out["zigzag"] = torch.as_tensor(np.asarray(ZIGZAG, np.int64)).to(device)
    out["packed"] = pack_symbol_luts(out)
    return out


_PACKED_LUTS = (("dc_code", 32), ("dc_len", 32), ("ac_code", 512), ("ac_len", 512),
                ("zrl_code", 2), ("zrl_len", 2), ("eob_code", 2), ("eob_len", 2))


def pack_symbol_luts(luts: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The symbol tables as one int32 tensor, in the layout of
    csrc/symbols.cuh (SYM_DC_CODE ... SYM_EOB_LEN), for the kernel to stage
    in shared memory."""
    parts = []
    for name, size in _PACKED_LUTS:
        t = luts[name].reshape(-1).to(torch.int32)
        if t.numel() != size:
            raise ValueError(f"{name}: expected {size} values, got {t.numel()}")
        parts.append(t)
    return torch.cat(parts)


def build_entropy_luts(dc_luma, ac_luma, dc_chroma, ac_chroma, device) -> dict:
    """Stack the Huffman tables into (2, n) int32 LUTs on ``device`` (row 0
    luma, row 1 chroma), with the ZRL and EOB codes of each table."""
    dl_code, dl_len = huffman_lut(dc_luma, 16)
    dch_code, dch_len = huffman_lut(dc_chroma, 16)
    al_code, al_len = huffman_lut(ac_luma, 256)
    ach_code, ach_len = huffman_lut(ac_chroma, 256)
    return entropy_luts_from_numpy(
        {
            "dc_code": np.stack([dl_code, dch_code]),
            "dc_len": np.stack([dl_len, dch_len]),
            "ac_code": np.stack([al_code, ach_code]),
            "ac_len": np.stack([al_len, ach_len]),
            "zrl_code": np.array([al_code[0xF0], ach_code[0xF0]]),
            "zrl_len": np.array([al_len[0xF0], ach_len[0xF0]]),
            "eob_code": np.array([al_code[0x00], ach_code[0x00]]),
            "eob_len": np.array([al_len[0x00], ach_len[0x00]]),
        },
        device,
    )


# --------------------------------------------------------------------------- #
# Symbol streams
# --------------------------------------------------------------------------- #


def _bit_size(v: torch.Tensor) -> torch.Tensor:
    """JPEG size category (bits of |v|), read from the f32 exponent: exact
    for |v| < 2^24, and JPEG magnitudes are at most 2047."""
    mag = v.abs().to(torch.int32)
    fbits = mag.to(torch.float32).view(torch.int32)
    return torch.where(mag == 0, 0, (fbits >> 23) - 126)


def _zz_permute(seq: torch.Tensor, zigzag: torch.Tensor) -> torch.Tensor:
    """(B, 64) natural-order coefficients -> zigzag order (a gather)."""
    return seq[:, zigzag]


def _prev_nonzero_scan(nz: torch.Tensor, pos: torch.Tensor):
    """(incl_cummax, prev_nz, last_nz): for each AC position, the position
    of the last nonzero at or before it, at or before the one before it,
    and in the whole block (0 where there is none)."""
    incl = torch.cummax(torch.where(nz, pos, 0), dim=1).values
    prev_nz = torch.nn.functional.pad(incl[:, :-1], (1, 0))
    return incl, prev_nz, incl[:, -1]


def _per_mcu(sampling: str) -> tuple[int, int, int]:
    return (4, 1, 1) if sampling == "420" else (1, 1, 1)


def _mcu_sequence(yb, cbb, crb, luts, sampling: str):
    """Interleave the components' blocks into MCU scan order, zigzag them,
    and give each block its table (0 luma, 1 chroma)."""
    n = cbb.shape[0]
    per_mcu = _per_mcu(sampling)
    seq = torch.cat(
        [c.reshape(n, k, 64) for c, k in zip((yb, cbb, crb), per_mcu)], dim=1
    ).reshape(-1, 64).to(torch.int32)
    zz = _zz_permute(seq, luts["zigzag"])
    per = sum(per_mcu)
    tsel = (torch.arange(seq.shape[0], device=seq.device) % per >= per_mcu[0]).to(torch.int64)
    return zz, tsel


def _streams_from_diffs(zz, tsel, diffs, luts):
    """(codes, lens), each (B, 65) int32: DC with its difference bits, one
    slot per AC position (ZRL on the 16th zero of a run that a later nonzero
    ends), and EOB unless position 63 is nonzero. Empty slots carry 0."""
    dsz = _bit_size(diffs)
    mask = (1 << dsz) - 1
    dval = torch.where(diffs < 0, diffs + mask, diffs) & mask
    dsz_i = dsz.to(torch.int64)
    dc_codes = (luts["dc_code"][tsel, dsz_i] << dsz) | dval
    dc_lens = luts["dc_len"][tsel, dsz_i] + dsz

    v = zz[:, 1:]
    nz = v != 0
    pos = torch.arange(1, 64, dtype=torch.int32, device=v.device).expand_as(v)
    _incl, prev_nz, last_nz = _prev_nonzero_scan(nz, pos)
    run = pos - prev_nz - 1
    asz = _bit_size(v)
    amask = (1 << asz) - 1
    aval = torch.where(v < 0, v + amask, v) & amask
    sym = (((run % 16) << 4) | asz).to(torch.int64)
    t2 = tsel[:, None]
    main_codes = (luts["ac_code"][t2, sym] << asz) | aval
    main_lens = torch.where(nz, luts["ac_len"][t2, sym] + asz, 0)
    zrl_here = (~nz) & ((pos - prev_nz) % 16 == 0) & (pos < last_nz[:, None])
    ac_codes = torch.where(nz, main_codes, luts["zrl_code"][t2])
    ac_lens = torch.where(nz, main_lens, torch.where(zrl_here, luts["zrl_len"][t2], 0))

    eob_lens = torch.where(last_nz != 63, luts["eob_len"][tsel], 0)
    codes = torch.cat([dc_codes[:, None], ac_codes, luts["eob_code"][tsel][:, None]], dim=1)
    lens = torch.cat([dc_lens[:, None], ac_lens, eob_lens[:, None]], dim=1)
    return torch.where(lens > 0, codes, 0).to(torch.int32), lens.to(torch.int32)


def symbol_streams_plain(yb, cbb, crb, luts, n_groups: int = 1, sampling: str = "444",
                         prev_dc: torch.Tensor | None = None):
    """Plain torch symbol streams over one flat block array in MCU scan
    order: each component's DC chain restarts from 0 at every one of
    ``n_groups`` equal restart groups (T.81 E.2.4), or continues from
    ``prev_dc`` ((3,) int32, one group). Returns (codes, lens), each
    (B, 65) int32. The plain version of ``kernels.symbol_streams``."""
    n = cbb.shape[0]
    zz, tsel = _mcu_sequence(yb, cbb, crb, luts, sampling)
    parts = []
    for ci, (c, k) in enumerate(zip((yb, cbb, crb), _per_mcu(sampling))):
        dc_c = c[:, 0].to(torch.int32).reshape(n_groups, -1)
        if prev_dc is None:
            first = torch.zeros((n_groups, 1), dtype=torch.int32, device=dc_c.device)
        else:
            first = prev_dc[ci : ci + 1].to(torch.int32).reshape(1, 1)
        prev_c = torch.cat([first, dc_c[:, :-1]], dim=1)
        parts.append((dc_c - prev_c).reshape(n, k))
    diffs = torch.cat(parts, dim=1).reshape(-1)
    return _streams_from_diffs(zz, tsel, diffs, luts)


def _symbol_streams_flat(yb, cbb, crb, luts, n_groups: int, sampling: str = "444"):
    """Restart-group symbol streams: DC chains reset to 0 at every group
    boundary. Returns (codes, lens), each (B, 65) int32, B blocks in MCU
    scan order."""
    return symbol_streams(yb, cbb, crb, luts, n_groups, sampling)[:2]


def _symbol_streams(yb, cbb, crb, luts, prev_dc, sampling: str = "444"):
    """Carried symbol streams: each component's DC chain continues from
    ``prev_dc`` ((3,) int32). Returns (codes, lens, new_dc)."""
    codes, lens, _bits, new_dc = symbol_streams(yb, cbb, crb, luts, 1, sampling, prev_dc=prev_dc)
    return codes, lens, new_dc


def _exclusive_cumsum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    return torch.cumsum(x, dim) - x


# --------------------------------------------------------------------------- #
# Layout, pack and merge
# --------------------------------------------------------------------------- #


def _group_layout(lens: torch.Tensor, n_groups: int):
    """Dense layout of ``n_groups`` equal restart groups: group g starts at
    word cumsum(ceil(bits/32))[g], its blocks one after another. Returns
    (starts (B,) int32 global start bits, group_bits (n_groups,) int32,
    block_bits (B,) int32)."""
    block_bits = lens.sum(dim=1, dtype=torch.int32)
    starts, group_bits = _layout_from_bits(block_bits, n_groups)
    return starts, group_bits, block_bits


def _layout_from_bits(block_bits: torch.Tensor, n_groups: int):
    per_group = block_bits.reshape(n_groups, -1)
    group_bits = per_group.sum(dim=1, dtype=torch.int32)
    used = (group_bits + 31) >> 5
    dense_base = _exclusive_cumsum(used.to(torch.int64))
    starts = (dense_base[:, None] << 5) + _exclusive_cumsum(per_group.to(torch.int64), 1)
    return starts.reshape(-1).to(torch.int32), group_bits


def group_layout_plain(block_bits: torch.Tensor, n_groups: int = 1,
                       bit_base: torch.Tensor | None = None):
    """Plain torch layout, the plain version of ``kernels.group_layout``:
    the dense layout of restart groups, or, given ``bit_base``, the carried
    stream's int64 cumulative sum from that bit. Returns (starts, group_bits,
    max_block_bits, total_bits, next_base) as ``group_layout`` does."""
    max_bits = block_bits.max()
    if bit_base is None:
        starts, group_bits = _layout_from_bits(block_bits, n_groups)
        return starts, group_bits, max_bits, None, None
    bits64 = block_bits.to(torch.int64)
    starts64 = bit_base.to(torch.int64) + _exclusive_cumsum(bits64)
    total_bits = bit_base.to(torch.int64) + bits64.sum()
    group_bits = block_bits.sum(dim=0, keepdim=True, dtype=torch.int32)
    return starts64.to(torch.int32), group_bits, max_bits, total_bits, total_bits % 8


def pack_groups_from_blocks(yb, cbb, crb, luts: dict, n_groups: int, cap_words: int,
                            sampling: str = "444", local_words: int = LOCAL_WORDS):
    """Entropy-pack quantized blocks as ``n_groups`` restart groups, laid
    out densely in ``n_groups * cap_words`` words (the capacity is pooled).
    On the card: symbol_streams, group_layout, the memset of the words and
    pack_merge, and nothing between them.

    Returns (dense (n_groups * cap_words,) int32, group_bits (n_groups,)
    int32, max_block_bits () int32, max_overlap () int32). The merge has no
    per-word overlap bound, so ``max_overlap`` is always 0, a host
    constant. Where the start bits could pass 2^31 (``kernels.
    stream_fits_int32``), neither the layout nor the pack runs and all four
    are None: the caller codes the band on the host."""
    codes, lens, block_bits, _dc = symbol_streams(yb, cbb, crb, luts, n_groups, sampling)
    if not stream_fits_int32(block_bits.shape[0], local_words):
        return None, None, None, None
    starts, group_bits, max_bits, _, _ = group_layout(block_bits, n_groups)
    dense = pack_merge(codes, lens, starts, local_words, n_groups * cap_words)
    return dense, group_bits, max_bits, torch.zeros((), dtype=torch.int32)


def _pack_carried(yb, cbb, crb, luts: dict, prev_dc: torch.Tensor, bit_base: torch.Tensor,
                  cap_words: int, local_words: int, sampling: str):
    """``entropy_pack_carried`` and the next band's ``bit_base``
    (total_bits % 8), which the layout gives with the rest. On the card:
    symbol_streams, group_layout, the memset of the words and pack_merge, and
    nothing between them. Where the start bits could pass 2^31 (``kernels.
    stream_fits_int32``), neither the layout nor the pack runs: ``words``
    and ``max_bits`` are None, and the total and the next base come from
    the bit counts' int64 sum, so the chain stays exact while the caller
    codes the band on the host."""
    codes, lens, block_bits, new_dc = symbol_streams(yb, cbb, crb, luts, 1, sampling,
                                                     prev_dc=prev_dc)
    if not stream_fits_int32(block_bits.shape[0], local_words):
        total_bits = bit_base.to(torch.int64) + block_bits.sum(dtype=torch.int64)
        return None, total_bits, new_dc, None, total_bits % 8
    starts, _group_bits, max_bits, total_bits, next_base = group_layout(
        block_bits, 1, bit_base.to(torch.int64))
    words = pack_merge(codes, lens, starts, local_words, cap_words)
    return words, total_bits, new_dc, max_bits, next_base


def entropy_pack_carried(yb, cbb, crb, luts: dict, prev_dc: torch.Tensor,
                         bit_base: torch.Tensor, cap_words: int,
                         local_words: int = LOCAL_WORDS, sampling: str = "444"):
    """Entropy-pack one band of the carried stream (no restart markers): DC
    predictors continue from ``prev_dc`` and the first block starts at bit
    ``bit_base`` (0..7, the previous band's partial byte).

    Returns (words (cap_words,) int32, total_bits () int64 including
    bit_base, new_dc (3,) int32, max_block_bits () int32). The words equal
    the JAX package's ``entropy_pack_trace_v2`` up to ceil(total_bits/32).
    ``words`` and ``max_block_bits`` are None where the start bits could
    pass 2^31."""
    return _pack_carried(yb, cbb, crb, luts, prev_dc, bit_base, cap_words, local_words,
                         sampling)[:4]


# --------------------------------------------------------------------------- #
# Streaming encoder
# --------------------------------------------------------------------------- #


def _stuff(payload: np.ndarray) -> bytes:
    """JPEG byte stuffing: a 0x00 after every 0xFF."""
    with span("jpeg.stuff") as s:
        ff = np.nonzero(payload == 0xFF)[0]
        if len(ff):
            payload = np.insert(payload, ff + 1, 0)
        out = payload.tobytes()
        s.n = len(out)
    return out


def _words_to_bytes(words: torch.Tensor) -> bytes:
    """int32 word tensor -> big-endian bytes of its uint32 bit patterns."""
    return words.cpu().numpy().view(np.uint32).astype(">u4").tobytes()


def unpack_rgba(band):
    """A rank-2 band is byte-packed RGBA, one little-endian uint32 a pixel
    (r | g << 8 | b << 16 | a << 24, the JAX package's packed decode
    handoff): returns its (H, W, 4) uint8 view, the same bytes. A host
    array is viewed as the JAX package's ``_unpack_rgba`` views it; a
    tensor is viewed where it lies, with no arithmetic (torch's CPU build
    has no uint32 shifts). Any other band is returned as it is."""
    if getattr(band, "ndim", None) != 2:
        return band
    h, w = band.shape
    if isinstance(band, torch.Tensor):
        return band.contiguous().view(torch.uint8).view(h, w, 4)
    return np.ascontiguousarray(band).view(np.uint8).reshape(h, w, 4)


class TorchJpegEncoder:
    """Streaming band encoder on a torch device; the counterpart of
    ``image_stitch_tpu.ops.jpeg_entropy_device.DeviceJpegEncoder``.

    ``submit`` takes a band on the device, or uploads a host band, and
    queues quantize, symbols, pack and merge there, threading the DC predictors and the bit offset of
    the carried stream through device tensors, so consecutive submits never
    wait for the device. ``wait`` is the only place that reads device
    values back. With ``restart_interval_rows`` > 0 each band is packed as
    independent restart groups; the caller submits group-aligned bands, and
    a shorter group only at the end of the image.

    With ``mesh``, ``device`` is the mesh's first device. The band's whole
    restart groups are split by ``row_slabs(rows, mesh.size, ri * mcu_px)``
    and each non-empty slab is read onto its shard (uploaded from a host
    band; viewed or copied from a tensor or a ``ShardedBand``) and packed
    there; the final short group goes to the first shard. Without restart
    groups the carried stream stays on the first shard. The tables are made
    once per distinct device of the mesh.

    A rank-2 band is byte-packed RGBA (``unpack_rgba``) and is taken as its
    uint8 view.

    A host band goes up as it lies, alpha and all: one copy into the next
    buffer of the encoder's staging ring (``BandStaging``, made on the
    first host band), then one queued copy to the device. Once ``submit``
    returns, the caller may write over its array. The uploaded band is
    dropped as soon as its quantize is queued, before the symbol slots are
    allocated: the caching allocator reuses its block in stream order.
    """

    # Bucketed per-group capacity budgets in bits/px (the JAX package's
    # ladder): quiet content runs the merge at a fraction of the default.
    _CAP_BUCKETS = (1.0, 1.5, 2.0, 2.5, 3.0, 4.0, 6.0, 8.0, 12.0)

    def __init__(self, luma_q, chroma_q, dc_luma, ac_luma, dc_chroma, ac_chroma, *,
                 device, cap_bits_per_px: int = DEFAULT_CAP_BITS_PER_PX,
                 restart_interval_rows: int = 0, sampling: str = "444",
                 local_words: int = LOCAL_WORDS,
                 counters: EncodeCounters | None = None, mesh: Mesh | None = None):
        self.mesh = mesh
        self.device = mesh.flat()[0] if mesh is not None else resolve_device(device)
        self.counters = counters if counters is not None else EncodeCounters()
        self._local_words = int(local_words)
        # Quantizers and symbol tables on each device the encoder runs on.
        self._tables = {
            dev: (_to_int32(luma_q, dev), _to_int32(chroma_q, dev),
                  build_entropy_luts(dc_luma, ac_luma, dc_chroma, ac_chroma, dev))
            for dev in (mesh.distinct() if mesh is not None else [self.device])
        }
        self._host_tables = (dc_luma, ac_luma, dc_chroma, ac_chroma)
        self._prev_dc = torch.zeros(3, dtype=torch.int32, device=self.device)
        self._bit_base = torch.zeros((), dtype=torch.int64, device=self.device)
        # Host side of the carried stream's partial byte: value and bit count.
        self._carry_val = 0
        self._host_carry_n = 0
        self._cap_bits_per_px = cap_bits_per_px
        self._restart_rows = int(restart_interval_rows)
        self._groups_emitted = 0
        self._rst_n = 0
        self._sampling = sampling
        self._mcu_px = 16 if sampling == "420" else 8
        # Max group bits/px of recent bands: sizes the next submit's output.
        self._cap_recent = collections.deque(maxlen=4)
        self._staging: BandStaging | None = None

    # ---- submit ------------------------------------------------------------

    def _upload(self, band: np.ndarray) -> torch.Tensor:
        """Host (H, W, C >= 3) uint8 band -> the same (H, W, C) on the
        device, contiguous: one copy into the next buffer of the staging
        ring, one queued copy up. On the CPU the result is a view of that
        buffer, good until the ring hands it out again."""
        if (not isinstance(band, np.ndarray) or band.dtype != np.uint8 or band.ndim != 3
                or band.shape[2] < 3):
            raise TypeError("TorchJpegEncoder takes an (H, W, C >= 3) uint8 ndarray or tensor")
        if self._staging is None:
            self._staging = BandStaging(self.device)
        ring = self._staging
        h, w, _ = band.shape
        with span("jpeg.upload", h * w * 3):
            stalls = ring.stalls
            slot, buf = ring.acquire(band.nbytes)
            self.counters.staging_stalls += ring.stalls - stalls
            with span("jpeg.upload.copy"):
                np.copyto(buf[: band.nbytes].numpy().reshape(band.shape), band)
            self.counters.staged_uploads += 1
            return ring.upload(slot, band.nbytes).view(band.shape)

    def on_device(self, band) -> torch.Tensor:
        """``band`` as an (H, W, C >= 3) uint8 tensor on the encoder's
        device: a tensor is taken where it lies, and must lie there (no
        copy from another device); a host array is uploaded; a
        ``ShardedBand``'s slabs are joined there; a packed band is viewed
        as RGBA first."""
        band = unpack_rgba(band)
        if isinstance(band, ShardedBand):
            band = band.rows(0, band.shape[0], self.device)
        if not isinstance(band, torch.Tensor):
            return self._upload(band)
        if band.device != self.device:
            raise ValueError(f"band on {band.device}, the encoder runs on {self.device}")
        if band.dtype != torch.uint8 or band.ndim != 3 or band.shape[2] < 3:
            raise TypeError(f"expected an (H, W, C >= 3) uint8 band, got "
                            f"{tuple(band.shape)} {band.dtype}")
        return band.contiguous()

    def _quantize(self, band: torch.Tensor):
        fn = jpeg_quantize_420 if self._sampling == "420" else jpeg_quantize
        lq, cq, _luts = self._tables[band.device]
        return fn(band, lq, cq)

    def _on_shard(self, shard: int | None):
        """The context of mesh shard ``shard``; none without a mesh."""
        return contextlib.nullcontext() if shard is None else self.mesh.shard(shard)

    def submit(self, band):
        """Queue one band (rows a multiple of the MCU height, width padded
        to whole MCUs), a host array or a tensor on the encoder's device (or
        a ``ShardedBand`` under a mesh); returns a handle for ``wait``."""
        with span("jpeg.submit"):
            return self._submit(band)

    def _submit(self, band):
        band = unpack_rgba(band)
        if self.mesh is not None and self._restart_rows:
            if not isinstance(band, (torch.Tensor, ShardedBand)):
                band = np.asarray(band)[..., :3]  # JPEG ignores alpha: upload less
            self.counters.bands += 1
            return self._submit_groups(band)
        shard = None if self.mesh is None else 0
        with self._on_shard(shard):
            dev_band = self.on_device(band)
            self.counters.bands += 1
            h, w = dev_band.shape[:2]
            # The band is dropped once its quantize is queued (class doc).
            if not self._restart_rows:
                blocks = self._quantize(dev_band)
                del dev_band
                return self._submit_carried(blocks, h * w, shard)
            pieces = [(self._quantize(dev_band[r0:r1]), n_groups, (r1 - r0) // n_groups * w)
                      for r0, r1, n_groups, _ in self._group_pieces(h)]
            del dev_band
            return ("groups", [self._dispatch_pending(*p) for p in pieces])

    def _submit_carried(self, blocks, n_pixels: int, shard: int | None):
        prev_dc_in = self._prev_dc
        cap_words = max(64, (n_pixels * self._cap_bits_per_px + 31) // 32)
        words, total_bits, new_dc, max_bb, next_base = _pack_carried(
            *blocks, self._tables[self.device][2], prev_dc_in, self._bit_base, cap_words,
            self._local_words, self._sampling,
        )
        self._prev_dc = new_dc
        self._bit_base = next_base
        if shard is not None:
            self.counters.mesh_dispatches += 1
        return ("carried", words, total_bits, cap_words, max_bb, blocks,
                prev_dc_in, self._local_words)

    def _group_cap_bits_px(self) -> float:
        """Per-group capacity budget in bits/px: the recent peak * 1.15,
        bucketed; the configured value until a band has reported."""
        if not self._cap_recent:
            return float(self._cap_bits_per_px)
        want = max(self._cap_recent) * 1.15
        for b in self._CAP_BUCKETS:
            if b >= want:
                return min(b, float(MAX_CAP_BITS_PER_PX))
        return float(MAX_CAP_BITS_PER_PX)

    def _group_pieces(self, rows: int):
        """The dispatches of a band of ``rows`` rows: (first row, end row,
        restart groups, mesh shard or None). The band's whole groups go in
        one, or under a mesh in one per shard that holds some; a final
        shorter group (the tail of the image) in another, on the first
        shard."""
        ri = self._restart_rows
        mcu_rows = rows // self._mcu_px
        tail_rows = mcu_rows % ri
        main_rows = mcu_rows - tail_rows
        main_px = main_rows * self._mcu_px
        pieces = []
        if main_rows and self.mesh is None:
            pieces.append((0, main_px, main_rows // ri, None))
        elif main_rows:
            group_px = ri * self._mcu_px
            for i, (r0, r1) in enumerate(row_slabs(main_px, self.mesh.size, group_px)):
                if r1 > r0:
                    pieces.append((r0, r1, (r1 - r0) // group_px, i))
        if tail_rows:
            pieces.append((main_px, rows, 1, None if self.mesh is None else 0))
        return pieces

    def _submit_groups(self, band):
        """Under a mesh: each dispatch's rows read onto its shard from the
        band as it lies (a host array, a tensor or a ``ShardedBand``), then
        quantized and packed there."""
        handles = []
        for r0, r1, n_groups, shard in self._group_pieces(band.shape[0]):
            with self.mesh.shard(shard) as dev:
                slab = band_rows(band, r0, r1, dev).contiguous()
                handles.append(self._dispatch_pending(
                    self._quantize(slab), n_groups, (r1 - r0) // n_groups * band.shape[1], shard))
        return ("groups", handles)

    def _dispatch_pending(self, blocks, n_groups: int, px_per_group: int,
                          shard: int | None = None):
        """Pack the quantized blocks of ``n_groups`` equal restart groups in
        one dispatch (the JAX package's batched dispatch, with a batch of 1),
        on mesh shard ``shard`` when there is one."""
        cap_words = max(64, (int(px_per_group * self._group_cap_bits_px()) + 31) // 32)
        dense, group_bits, max_bb, _ = pack_groups_from_blocks(
            *blocks, self._tables[blocks[0].device][2], n_groups, cap_words,
            sampling=self._sampling, local_words=self._local_words,
        )
        if shard is not None:
            self.counters.mesh_dispatches += 1
        return (dense, group_bits, max_bb, blocks, n_groups, cap_words,
                px_per_group, self._local_words, shard)

    # ---- wait --------------------------------------------------------------

    def _rst_marker(self) -> bytes:
        m = bytes([0xFF, 0xD0 + self._rst_n])
        self._rst_n = (self._rst_n + 1) & 7
        return m

    def _repack_on_device(self, blocks, bits_h: np.ndarray, max_bb: int, n_groups: int):
        """Pack an overflowed band again from its device-resident blocks,
        with a per-block budget that holds ``max_bb`` and the pooled
        capacity its exact group bit counts need. Returns (dense,
        cap_words), or None when no budget holds the blocks or their start
        bits could pass 2^31 at the budget that does."""
        local_words = self._local_words
        if max_bb > local_words * 32:
            for cand in (12, 16, LOCAL_WORDS):
                if cand > local_words and max_bb <= cand * 32:
                    local_words = cand
                    break
            if max_bb > local_words * 32:
                return None
            # Later bands keep the larger budget: content proved it needed.
            self._local_words = local_words
        if not stream_fits_int32(sum(b.shape[0] for b in blocks), local_words):
            return None
        used = (bits_h + 31) // 32
        need_per_group = -(-int(used.sum()) // n_groups)
        cap_words = max(64, -(-need_per_group // 256) * 256)
        self.counters.repacks += 1
        dense, _bits, _max_bb, _ov = pack_groups_from_blocks(
            *blocks, self._tables[blocks[0].device][2], n_groups, cap_words,
            sampling=self._sampling, local_words=local_words,
        )
        return dense, cap_words

    def _wait_groups(self, handles) -> bytes:
        out = bytearray()
        for (dense, bits, max_bb, blocks, n_groups, cap_words, px_per_group,
             packed_lw, shard) in handles:
            if dense is None:
                # The dispatch's start bits could pass 2^31: no pack ran.
                self.counters.host_fallback_bands += 1
                out += self._host_fallback_groups(blocks, n_groups)
                continue
            with span("jpeg.device_wait", bits.numel() * bits.element_size()):
                bits_h = bits.cpu().numpy().astype(np.int64)
            max_bb = int(max_bb)
            used = (bits_h + 31) // 32
            total_used = int(used.sum())
            # The dense layout only needs the band's TOTAL words to fit.
            pooled_over = total_used > n_groups * cap_words
            budget_over = max_bb > packed_lw * 32
            if pooled_over or budget_over:
                with self._on_shard(shard):
                    repack = self._repack_on_device(blocks, bits_h, max_bb, n_groups)
                if repack is None:
                    self.counters.host_fallback_bands += 1
                    out += self._host_fallback_groups(blocks, n_groups)
                    continue
                dense, cap_words = repack
            self._cap_recent.append(float(bits_h.max()) / max(1, px_per_group))
            offs = np.concatenate([[0], np.cumsum(used)[:-1]])
            dense_b = _words_to_bytes(dense[:total_used])
            for g in range(n_groups):
                if self._groups_emitted:
                    out += self._rst_marker()
                self._groups_emitted += 1
                total = int(bits_h[g])
                n_bytes = (total + 7) // 8
                data = bytearray(dense_b[offs[g] * 4 : offs[g] * 4 + n_bytes])
                rem = total % 8
                if rem and n_bytes:
                    data[-1] |= (1 << (8 - rem)) - 1  # pad the last byte with 1s
                out += _stuff(np.frombuffer(bytes(data), dtype=np.uint8))
        return bytes(out)

    def _interleave_host(self, yc, yl, cbc, cbl, crc, crl):
        if self._sampling != "420":
            return interleave_mcus([(yc, yl), (cbc, cbl), (crc, crl)])
        codes_parts, lens_parts = [], []
        for m in range(len(cbc)):
            for j in range(4):
                codes_parts.append(yc[m * 4 + j])
                lens_parts.append(yl[m * 4 + j])
            codes_parts += [cbc[m], crc[m]]
            lens_parts += [cbl[m], crl[m]]
        return np.concatenate(codes_parts), np.concatenate(lens_parts)

    def _host_blocks(self, blocks):
        return [b.cpu().numpy() for b in blocks]

    def _host_fallback_groups(self, blocks, n_groups: int) -> bytes:
        """Exact host coding of a group-aligned band (the overflow path)."""
        yb, cbb, crb = self._host_blocks(blocks)
        dc_l, ac_l, dc_c, ac_c = self._host_tables
        enc_l = HuffmanEncoder(dc_l, ac_l)
        enc_c = HuffmanEncoder(dc_c, ac_c)
        ybpg = yb.shape[0] // n_groups
        cbpg = cbb.shape[0] // n_groups
        out = bytearray()
        for g in range(n_groups):
            if self._groups_emitted:
                out += self._rst_marker()
            self._groups_emitted += 1
            ysl = slice(g * ybpg, (g + 1) * ybpg)
            csl = slice(g * cbpg, (g + 1) * cbpg)
            packer = BitPacker()
            yc, yl, _ = enc_l.encode_component_blocks(yb[ysl], 0)
            cbc, cbl, _ = enc_c.encode_component_blocks(cbb[csl], 0)
            crc, crl, _ = enc_c.encode_component_blocks(crb[csl], 0)
            codes, lens = self._interleave_host(yc, yl, cbc, cbl, crc, crl)
            out += packer.pack(codes, lens)
            out += packer.flush()
        return bytes(out)

    def wait(self, handle) -> bytes:
        """Entropy-coded bytes of a submitted band (stuffed; the carried
        stream's last partial byte is held back for the next band)."""
        with span("jpeg.wait"):
            return self._wait(handle)

    def _wait(self, handle) -> bytes:
        if handle[0] == "groups":
            return self._wait_groups(handle[1])
        _, words, total_bits, cap_words, max_bb, blocks, prev_dc_in, packed_lw = handle
        with span("jpeg.device_wait", total_bits.element_size()):
            total_bits = int(total_bits)
        if words is None:
            # The band's start bits could pass 2^31: no pack ran.
            self.counters.host_fallback_bands += 1
            return self._host_fallback_blocks(blocks, prev_dc_in)
        if int(max_bb) > packed_lw * 32 or total_bits > cap_words * 32:
            # Overflow: code this band on the host from its (exact) blocks.
            # The device carry chain stays valid: total_bits and new_dc are
            # exact either way. A capacity miss doubles later bands' budget.
            if total_bits > cap_words * 32 and self._cap_bits_per_px < MAX_CAP_BITS_PER_PX:
                self._cap_bits_per_px = min(MAX_CAP_BITS_PER_PX, self._cap_bits_per_px * 2)
            self.counters.host_fallback_bands += 1
            return self._host_fallback_blocks(blocks, prev_dc_in)
        data = bytearray(_words_to_bytes(words[: (total_bits + 31) // 32]))
        # The band started at bit (previous total % 8): OR in the held-back
        # bits of the previous band's last byte.
        if self._host_carry_n and data:
            data[0] |= (self._carry_val << (8 - self._host_carry_n)) & 0xFF
        full_bytes = total_bits // 8
        rem = total_bits % 8
        if rem:
            carry_byte = data[full_bytes] if full_bytes < len(data) else 0
            self._carry_val = carry_byte >> (8 - rem)
        else:
            self._carry_val = 0
        self._host_carry_n = rem
        return _stuff(np.frombuffer(bytes(data[:full_bytes]), dtype=np.uint8))

    def _host_fallback_blocks(self, blocks, prev_dc_in) -> bytes:
        yb, cbb, crb = self._host_blocks(blocks)
        dc_l, ac_l, dc_c, ac_c = self._host_tables
        enc_l = HuffmanEncoder(dc_l, ac_l)
        enc_c = HuffmanEncoder(dc_c, ac_c)
        packer = BitPacker()
        packer._carry_val = self._carry_val
        packer._carry_n = self._host_carry_n
        prev = [int(x) for x in prev_dc_in.cpu().numpy()]
        yc, yl, _ = enc_l.encode_component_blocks(yb, prev[0])
        cbc, cbl, _ = enc_c.encode_component_blocks(cbb, prev[1])
        crc, crl, _ = enc_c.encode_component_blocks(crb, prev[2])
        codes, lens = self._interleave_host(yc, yl, cbc, cbl, crc, crl)
        out = packer.pack(codes, lens)
        self._carry_val = packer._carry_val
        self._host_carry_n = packer._carry_n
        return out

    def flush(self) -> bytes:
        """The carried stream's last partial byte, padded with 1s."""
        n = self._host_carry_n
        if n == 0:
            return b""
        pad = 8 - n
        byte = (self._carry_val << pad) | ((1 << pad) - 1)
        self._carry_val = 0
        self._host_carry_n = 0
        return b"\xff\x00" if byte == 0xFF else bytes([byte])
