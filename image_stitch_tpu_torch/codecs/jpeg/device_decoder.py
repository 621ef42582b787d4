"""JPEG band decoder on a torch device: host Huffman once, pixel math per
band on the device.

Counterpart of ``image_stitch_tpu/codecs/jpeg/device_decoder.py``. The
serial entropy stage runs once on the host: for a baseline stream the
native scan writes the transport itself
(``owned_decoder.decode_zigzag_coefficients``: int16 in zigzag order, with
each component's last nonzero position and peak), else
``owned_decoder.decode_coefficients`` (int32, natural order) and a NumPy
pass take the same transport from it. Per band, ``decode_tiles_band``
takes every tile of the band at once: the windows of zigzag-prefix
coefficients of all tiles and components, their quantizer tables and the
two kernels' tables go up in ONE copy from a pinned staging buffer, and two
launches do the rest (``ops/kernels.py``): ``idct_dequant_batch`` (dezigzag,
dequantize, islow IDCT, range limit of every window) and ``ycc_rgba_batch``
(crop, upsample, colour), which writes each tile's RGBA straight into the
caller's band at the tile's x offset. ``DeviceJpegDecoder.decode_band`` is a
band of one tile. On a CPU tensor both run their plain versions
(``ops/jpeg_idct_device``). Device memory stays proportional to a band: a
tile's coefficients live on the host and only a band's windows go up.

Upload: the band's zigzag prefix of K coefficients per block, K the image's
highest nonzero zigzag index + 1 rounded up to a multiple of 8. Photo
content at q85-q90 keeps K near 16-40 and chroma subsampled.

A grid job asks ``device_tile_bands`` for its ``DeviceTileBands``, the
tier's one owner there: which tiles it serves, which bands go to the
device whole, the rows of tiles it decodes into them, a served tile's rows
of a band assembled on the host, the staging ring and the ``decode_*``
counters. The job's assembly (``core``) keeps the host half.

Band windowing: h2v2 fancy upsampling reads one row beyond each band edge,
so a component's window holds one extra row on each side that is not an
image edge, and the rows it spoils are cropped after upsampling; the
filter's edge replication then acts only at true image edges, so every
band equals the whole-image decode.
"""

from __future__ import annotations

import os
from typing import Callable, Mapping, NamedTuple, Sequence

import numpy as np
import torch

from ...errors import StitchError
from ...ops.counters import EncodeCounters
from ...ops.resolve import resolve_device
from ...ops.kernels import (
    IDCT_INT32_MAX_DEQ,
    StagedTable,
    idct_dequant_batch,
    idct_job_table,
    ycc_rgba_batch,
    ycc_tile_table,
)
from ...native import jpeg_zigzag_prefix_native
from ...ops.staging import BandStaging
from ...utils.observability import span
from .owned_decoder import decode_coefficients, decode_zigzag_coefficients
from .tables import ZIGZAG

_ZIGZAG_POS = np.argsort(ZIGZAG)  # the zigzag position of each natural index


def _natural_figures(blocks: np.ndarray) -> tuple[int, int]:
    """A component's highest nonzero zigzag position (-1: none) and peak
    |coefficient|, from its (n, 64) natural-order blocks."""
    peak = max(int(blocks.max()), -int(blocks.min())) if blocks.size else 0
    nz = np.flatnonzero(blocks.any(axis=0))
    return (int(_ZIGZAG_POS[nz].max()) if len(nz) else -1), peak


def _band_window(y0: int, y1: int, comp_h: int, v_exp: int, fancy_v: bool):
    """Component-row window [wa, wb) needed for image rows [y0, y1), and
    the upsampled-window row offset of image row y0."""
    if v_exp == 1:
        wa, wb = y0, y1
        r0 = y0 - wa
    elif fancy_v:
        wa = max(0, y0 // 2 - 1)
        wb = min(comp_h, (y1 - 1) // 2 + 2)
        r0 = y0 - 2 * wa
    else:
        wa = y0 // v_exp
        wb = (y1 - 1) // v_exp + 1
        r0 = y0 - wa * v_exp
    return wa, wb, r0


class DeviceJpegDecoder:
    """Host-Huffman-once, device-decode-per-band JPEG decoder.

    ``safe`` is False for streams the band decode does not take: neither one
    nor three components, or a coefficient at or past 2^15 in magnitude
    (int16 transport). The IDCT runs in int64, exact for every int16
    coefficient and 16-bit quantizer, so the JAX package's other bound,
    |coef * q| <= M_SAFE of its two-limb int32 IDCT, is not kept: a stream
    with |coef * q| between M_SAFE and 2^15 * q decodes here on the device,
    and in the JAX package on the host, to the same bytes. Only hostile
    streams (DC accumulation past legal baseline's 2047) get there."""

    def __init__(self, data: bytes, device="cpu"):
        with span("decode.jpeg.entropy", len(data)):
            zz = decode_zigzag_coefficients(data)
            if zz is None:
                blocks, qtabs, geom, width, height = decode_coefficients(data)
                figures = [_natural_figures(b) for b in blocks]
            else:
                qtabs, geom, width, height = zz.qtabs, zz.geom, zz.width, zz.height
                figures = list(zip(zz.last, zz.peak))
        self.width = width
        self.height = height
        self.device = resolve_device(device)
        self._geom = geom  # (by, bx, comp_w, comp_h, h_exp, v_exp) per comp
        # Whether the transport came straight from the native scan.
        self.native_prefix = zz is not None
        zz_idx = np.asarray(ZIGZAG)
        # Quantizers in zigzag order, as csrc/idct.cu reads them.
        self._qtabs_zz = [np.ascontiguousarray(np.asarray(q, dtype=np.int32)[zz_idx])
                          for q in qtabs]
        self._k: list[int] = []
        # Per component: whether every |coefficient * quantizer| is within
        # the bound under which the IDCT's column pass is exact in 32 bits.
        self._narrow: list[bool] = []
        self.safe = len(geom) in (1, 3)
        for (last, peak), q in zip(figures, self._qtabs_zz):
            if peak >= (1 << 15):
                self.safe = False
            self._narrow.append(peak * int(np.abs(q).max()) <= IDCT_INT32_MAX_DEQ)
            # Image-wide zigzag prefix: K = last nonzero zigzag position + 1,
            # rounded up to a multiple of 8; only those columns are kept.
            self._k.append(min(64, -(-max(last + 1, 1) // 8) * 8))
        # The (n, K) int16 blocks that go up, a component each.
        if zz is None:
            # np.take: several times faster than fancy indexing here.
            self._zz_blocks = [np.take(b, zz_idx[:k], axis=1).astype(np.int16)
                               for b, k in zip(blocks, self._k)]
        else:
            try:
                self._zz_blocks = [jpeg_zigzag_prefix_native(b, k)
                                   for b, k in zip(zz.blocks, self._k)]
            finally:
                zz.release()
        self._staging: BandStaging | None = None

    def to(self, device) -> "DeviceJpegDecoder":
        """This stream's decoder on ``device``, sharing the host
        coefficients."""
        device = resolve_device(device)
        if device == self.device:
            return self
        other = object.__new__(DeviceJpegDecoder)
        other.__dict__.update(self.__dict__)
        other.device = device
        other._staging = None
        return other

    def windows(self, y0: int, y1: int) -> list[tuple[np.ndarray, int, tuple]]:
        """Per component, what the band decode of image rows [y0, y1)
        takes: the (n, k) int16 zigzag-prefix coefficients of the window's
        whole block rows (a view), the blocks a row, and the window's
        (h_exp, v_exp, r0, w0l, w1l, comp_w) for ``ycc_rgba``."""
        if not (0 <= y0 < y1 <= self.height):
            raise StitchError(f"Invalid band range [{y0}, {y1})")
        out = []
        for zz, (by, bx, comp_w, comp_h, h_exp, v_exp) in zip(self._zz_blocks, self._geom):
            fancy_v = v_exp == 2 and h_exp == 2 and comp_w > 2
            wa, wb, r0 = _band_window(y0, y1, comp_h, v_exp, fancy_v)
            bb, be = wa // 8, min(by, -(-wb // 8))
            out.append((zz[bb * bx : be * bx], bx,
                        (h_exp, v_exp, r0, wa - bb * 8, wb - bb * 8, comp_w)))
        return out

    def decode_band(self, y0: int, y1: int, return_device: bool = False,
                    out: torch.Tensor | None = None, x0: int = 0,
                    staging: "BandStaging | None" = None):
        """Decode image rows [y0, y1) to (y1 - y0, width, 4) uint8 RGBA: a
        tensor on the decoder's device when ``return_device``, else a host
        array. With ``out``, an (y1 - y0, W, 4) uint8 tensor on the device,
        the pixels go to its columns [x0, x0 + width) instead, and ``out``
        is returned. A band of one tile of ``decode_tiles_band``; ``staging``
        as there, else the decoder's own."""
        with span("decode.jpeg.band"):
            if out is None:
                out = torch.empty((y1 - y0, self.width, 4), dtype=torch.uint8,
                                  device=self.device)
                x0 = 0
            if staging is None:
                if self._staging is None:
                    self._staging = BandStaging(self.device)
                staging = self._staging
            decode_tiles_band([(self, y0, y1, x0)], out, staging)
            if return_device:
                return out
            return out.cpu().numpy()

    def decode_full(self, band_height: int = 512) -> np.ndarray:
        """Whole image via banded decode (host assembly)."""
        parts = [
            self.decode_band(y0, min(self.height, y0 + band_height))
            for y0 in range(0, self.height, band_height)
        ]
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)


def _align16(n: int) -> int:
    return -(-n // 16) * 16


class StagedBand(NamedTuple):
    """A band of tiles staged and uploaded: what the two kernels take. The
    coefficients and the quantizers are on the device; the job and tile
    tables are on the host, where the wrappers check them, and ``ctas`` and
    ``tile_rows`` carry the rows made from them to the device."""

    coefs: torch.Tensor
    qtabs: torch.Tensor
    jobs: torch.Tensor
    ctas: StagedTable
    tiles: torch.Tensor
    tile_rows: StagedTable
    plane_bytes: int
    staged_bytes: int


def stage_tiles_band(items, out: torch.Tensor, staging: BandStaging) -> StagedBand:
    """Build the two kernels' tables for one band of tiles (``items`` and
    ``out`` as ``decode_tiles_band`` takes them) and carry everything the
    band needs up in ONE copy: the IDCT's CTA table and the tile table, each
    distinct quantizer table once, and every window's coefficients (each a contiguous run of its
    decoder's zigzag-prefix blocks), each part at a 16 B boundary of one
    pinned buffer of ``staging``. On the CPU nothing is copied: the staged
    tensors are views of that buffer, good until the ring hands it out
    again."""
    device = out.device
    h = out.shape[0]
    qtab_of: dict[bytes, int] = {}
    qtabs: list[np.ndarray] = []
    windows, tiles, sources = [], [], []
    coef_at = plane_at = 0
    for dec, y0, y1, x0 in items:
        if dec.device != device or staging.device != device:
            raise StitchError(f"decoder on {dec.device}, staging on {staging.device}, "
                              f"band on {device}")
        if y1 - y0 != h:
            raise StitchError(f"rows [{y0}, {y1}) do not fill a band of {h} rows")
        comps = []
        for c, (zz, bx, (h_exp, v_exp, r0, w0l, w1l, comp_w)) in enumerate(dec.windows(y0, y1)):
            q = dec._qtabs_zz[c]
            key = q.tobytes()
            if key not in qtab_of:
                qtab_of[key] = len(qtabs)
                qtabs.append(q)
            n, k = zz.shape
            windows.append((coef_at, n, k, qtab_of[key], bx, plane_at, dec._narrow[c]))
            comps.append((plane_at, bx * 8, h_exp, v_exp, r0, w0l, w1l - w0l, comp_w))
            sources.append((coef_at, zz))
            coef_at += n * k  # k % 8 == 0: every window starts at a 16 B boundary
            plane_at += n * 64
        tiles.append((x0, dec.width, comps))
    jobs = idct_job_table(windows)
    tile_table = ycc_tile_table(tiles, out.shape[1], out.data_ptr())

    parts = (StagedTable.for_idct(jobs), StagedTable.for_ycc(tile_table))
    at, offsets = 0, []
    for t in parts:
        offsets.append(at)
        at = _align16(at + t.nbytes)
    q_at = at
    c_at = q_at + len(qtabs) * 256
    nbytes = c_at + coef_at * 2
    slot, host = staging.acquire(nbytes)
    host_np = host.numpy()
    for t, o in zip(parts, offsets):
        t.stage(host_np, o)
    for i, q in enumerate(qtabs):
        host_np[q_at + i * 256 : q_at + (i + 1) * 256] = q.view(np.uint8)
    coefs_np = host_np[c_at:nbytes].view(np.int16)
    for o, zz in sources:
        coefs_np[o : o + zz.size] = zz.reshape(-1)
    dev = staging.upload(slot, nbytes)
    for t in parts:
        t.bind(dev)
    return StagedBand(
        dev[c_at:nbytes].view(torch.int16), dev[q_at:c_at].view(torch.int32).view(-1, 64),
        jobs, parts[0], tile_table, parts[1], plane_at, nbytes)


def decode_tiles_band(items, out: torch.Tensor, staging: BandStaging) -> torch.Tensor:
    """Decode one band of several JPEG tiles into ``out``.

    ``items``: per tile (decoder, y0, y1, x0): the tile's image rows
    [y0, y1), as many as ``out`` has rows, go to ``out``'s columns
    [x0, x0 + decoder.width); ``out``: the (h, W, 4) uint8 band on the
    decoders' device; ``staging``: the ring of host buffers of that device.
    One upload (``stage_tiles_band``), then ``idct_dequant_batch`` fills the
    band's plane buffer and ``ycc_rgba_batch`` colours it into ``out``, with
    nothing between them. Returns ``out``."""
    with span("decode.jpeg.stage") as staged:
        band = stage_tiles_band(items, out, staging)
        staged.n = band.staged_bytes
    with span("decode.jpeg.launch"):
        planes = torch.empty(band.plane_bytes, dtype=torch.uint8, device=out.device)
        idct_dequant_batch(band.coefs, band.qtabs, band.jobs, planes, staged=band.ctas)
        return ycc_rgba_batch(planes, band.tiles, out, staged=band.tile_rows)


def device_tile_bands(device, output_format: str, bit_depth: int, width: int,
                      decoders: Sequence, headers: Sequence, tile_y0: Mapping[int, int],
                      counters: EncodeCounters,
                      note_rows: Callable[[int, int], None]) -> "DeviceTileBands | None":
    """The JPEG-tile device decode of one grid job, or None when no tile of
    it goes to the device: no ``device`` (the host tier), output other than
    JPEG, a canvas that is not 8-bit, or ``STITCH_TPU_DEVICE_DECODE=0``.
    The output bytes are the same either way, so this only routes.
    Arguments as ``DeviceTileBands`` takes them."""
    if (device is None or output_format != "jpeg" or bit_depth != 8
            or os.environ.get("STITCH_TPU_DEVICE_DECODE", "1") == "0"):
        return None
    return DeviceTileBands(device, width, decoders, headers, tile_y0, counters, note_rows)


class DeviceTileBands:
    """Which tiles of a grid job the device decodes, and their bands.

    ``decoders`` and ``headers``: each image index's decoder and its header;
    ``tile_y0``: each index's first canvas row; ``width``: the canvas's.
    An index is served when its header is 8-bit and its decoder's
    ``device_band_decoder`` gives a decoder on ``device``; it is asked once,
    on the index's first lookup (duplicate inputs may share one decoder). A
    served tile is read only by random access here, never also through the
    host's sequential rows. ``plan`` says whether a band is fully tiled by
    served tiles; ``band`` decodes such a band into one tensor, one upload
    and two launches for each row of tiles it crosses; ``rows`` decodes a
    served tile's rows of a band assembled on the host. ``note_rows(i, n)``
    hears of every ``n`` rows of index ``i`` served. Counters:
    ``decode_tiles_opened`` and ``decode_tiles_native_prefix`` per served
    index, ``decode_tile_bands`` per tile and band, ``decode_bands_on_device``
    per whole band, and, at ``close``, the staging ring's uploads and
    stalls."""

    def __init__(self, device, width: int, decoders: Sequence, headers: Sequence,
                 tile_y0: Mapping[int, int], counters: EncodeCounters,
                 note_rows: Callable[[int, int], None]):
        self.device = device
        self.width = width
        self._decoders = decoders
        self._headers = headers
        self._y0 = tile_y0
        self._counters = counters
        self._note_rows = note_rows
        self._tiles: dict[int, DeviceJpegDecoder | None] = {}
        self._ring: BandStaging | None = None

    def serves(self, i: int) -> bool:
        """Whether image index ``i`` is decoded by this tier."""
        if i not in self._tiles:
            get = getattr(self._decoders[i], "device_band_decoder", None)
            tile = get(self.device) if get is not None and self._headers[i].bit_depth == 8 else None
            self._counters.decode_tiles_opened += tile is not None
            self._counters.decode_tiles_native_prefix += tile is not None and tile.native_prefix
            self._tiles[i] = tile
        return self._tiles[i] is not None

    def _spans_width(self, segs) -> bool:
        """Whether ``segs``, left to right, tile the canvas's width, each
        from a served index."""
        x = 0
        for i, x0, w, _y0, _y1 in segs:
            if x0 != x or not self.serves(i):
                return False
            x = x0 + w
        return x == self.width

    def plan(self, band_y0: int, h: int, active):
        """The band's rows of tiles when canvas rows [band_y0, band_y0 + h)
        are fully tiled by served tiles, else None. ``active``: the band's
        segments (image index, x0, width, first row, end row), canvas rows.
        Each row of tiles, top to bottom, holds its segments left to right,
        all spanning the same rows and together the whole width."""
        rows: dict[tuple[int, int], list] = {}
        for seg in sorted(active, key=lambda a: (a[3], a[1])):
            rows.setdefault((seg[3], seg[4]), []).append(seg)
        y = band_y0
        for (seg_y0, seg_y1), segs in rows.items():
            if seg_y0 != y or not self._spans_width(segs):
                return None
            y = seg_y1
        return list(rows.values()) if y == band_y0 + h else None

    def band(self, band_y0: int, h: int, tile_rows) -> torch.Tensor:
        """The (h, width, 4) uint8 band at ``band_y0`` on the device, from
        ``tile_rows`` as ``plan`` gives them: each row of tiles in one
        ``decode_tiles_band``, into its rows of the band."""
        with span("decode.jpeg.band"):
            out = torch.empty((h, self.width, 4), dtype=torch.uint8, device=self.device)
            for segs in tile_rows:
                seg_y0, seg_y1 = segs[0][3], segs[0][4]
                items = [(self._tiles[i], seg_y0 - self._y0[i], seg_y1 - self._y0[i], x0)
                         for i, x0, _w, _y0, _y1 in segs]
                decode_tiles_band(items, out[seg_y0 - band_y0 : seg_y1 - band_y0],
                                  self._staging())
        self._counters.decode_bands_on_device += 1
        for segs in tile_rows:
            for i, _x0, _w, seg_y0, seg_y1 in segs:
                self._served(i, seg_y1 - seg_y0)
        return out

    def rows(self, i: int, seg_y0: int, seg_y1: int) -> np.ndarray:
        """Canvas rows [seg_y0, seg_y1) of served index ``i``, as a host
        array."""
        y0 = seg_y0 - self._y0[i]
        rows = self._tiles[i].decode_band(y0, y0 + (seg_y1 - seg_y0), staging=self._staging())
        self._served(i, seg_y1 - seg_y0)
        return rows

    def close(self) -> None:
        """Count the staging ring's uploads and stalls."""
        if self._ring is not None:
            self._counters.decode_staged_uploads += self._ring.uploads
            self._counters.decode_staging_stalls += self._ring.stalls

    def _served(self, i: int, n: int) -> None:
        self._counters.decode_tile_bands += 1
        self._note_rows(i, n)

    def _staging(self) -> BandStaging:
        """The job's ring of pinned buffers, made on first use."""
        if self._ring is None:
            self._ring = BandStaging(self.device)
        return self._ring
