"""Streaming baseline JPEG encoders: the band program in torch, or on the
host.

``StreamingJpegEncoder`` is the host tier (``backend="numpy"``): the JAX
package's ``StreamingJpegEncoder`` with its device branches dropped. A band
goes through the C++ host library's fused convert + DCT + quantize +
entropy call, per restart group when restart markers are on; else through
its quantize (``jpeg_quant_band_native``, ``_420``) and its entropy coder
(``NativeEntropyCoder``); without the library, through the port's plain
torch quantize on the CPU and the numpy Huffman coder (``huffman.py``).
It takes host arrays only: a tensor band is a routing fault and raises.

``TorchStreamingJpegEncoder`` is the JAX package's ``StreamingJpegEncoder``
(image_stitch_tpu/codecs/jpeg/encoder.py) with its fused device path as the
only path: headers, strip buffering, edge padding, restart-group alignment,
the in-flight queue (``STITCH_TPU_INFLIGHT``) and ``finish`` are that
class's, copied; every band goes to ``TorchJpegEncoder`` on ``device``.
A band may be a host array, which ``TorchJpegEncoder`` uploads, or a
tensor on ``device`` (decoded or blended there), which stays there: its
pending rows, edge padding and restart-group holdback are torch ops on the
device. Host and device bands may alternate in one stream. With a
``mesh`` (``parallel.mesh``) the restart groups are packed on its shards;
a ``ShardedBand`` of whole groups goes to them as it lies, any other is
joined on the mesh's first device.

Both encoders take a band byte-packed as (H, W) uint32 RGBA (the JAX
package's packed decode handoff) as its (H, W, 4) uint8 view,
``unpack_rgba``: the same bytes, so a stream may mix the two forms. Contract
preserved from the reference
(src/jpeg-encoder.ts:96-264):
- consumes 8-row RGBA MCU strips; SOI + headers are emitted with the first
  strip so ``header()`` yields nothing (jpeg-encoder.ts:123-152);
- partial final strips are padded by edge-pixel repetition
  (jpeg-encoder.ts:155-172);
- EOI is emitted by ``finish()`` (jpeg-encoder.ts:174-190);
- dimensions and quality (1-100) validated at construction
  (jpeg-encoder.ts:108-115);
- alpha is ignored (RGBA -> YCbCr drops A), like the reference encoder
  (tests/integration/background-color.test.ts:182-196).
"""

from __future__ import annotations

import collections
import os
from typing import Iterator

import numpy as np
import torch

from ...errors import StitchError
from ...native import (
    NativeEntropyCoder,
    jpeg_quant_band_420_native,
    jpeg_quant_band_native,
    make_huff_table,
    native_available,
)
from ...ops.backend import resolve_backend_name
from ...ops.counters import EncodeCounters
from ...ops.resolve import resolve_device
from ...ops.jpeg_dct import band_to_blocks_islow, band_to_blocks_islow_420
from ...ops.jpeg_entropy_device import TorchJpegEncoder, unpack_rgba
from ...parallel.mesh import Mesh, ShardedBand
from .huffman import BitPacker, HuffmanEncoder, interleave_mcus
from .tables import (
    STD_AC_CHROMA_BITS,
    STD_AC_CHROMA_VALS,
    STD_AC_LUMA_BITS,
    STD_AC_LUMA_VALS,
    STD_DC_CHROMA_BITS,
    STD_DC_CHROMA_VALS,
    STD_DC_LUMA_BITS,
    STD_DC_LUMA_VALS,
    ZIGZAG,
    build_huffman_codes,
    quality_scaled_tables,
)

MCU_HEIGHT = 8


def _repeat_edge(a, n: int, axis: int):
    """``a`` with its last row (axis 0) or column (axis 1) repeated ``n``
    more times: a host array, a tensor or, along axis 1, a ``ShardedBand``,
    as given."""
    if isinstance(a, ShardedBand):
        return ShardedBand([(r0, _repeat_edge(t, n, axis)) for r0, t in a.slabs])
    edge = a[-1:] if axis == 0 else a[:, -1:]
    if isinstance(a, torch.Tensor):
        return torch.cat([a, edge.repeat_interleave(n, dim=axis)], dim=axis)
    return np.concatenate([a, np.repeat(edge, n, axis=axis)], axis=axis)


def local_words_for_quality(quality: int) -> int:
    """Per-block word budget by quality, as the JAX package chooses it:
    blocks over budget are re-packed or coded on the host. Measured maxima
    on uniform noise: 330 bits at q85, 500 at q95, 782 at q100."""
    if quality <= 85:
        return 12
    if quality <= 95:
        return 16
    return 24


class TorchStreamingJpegEncoder:
    """Band-streaming JPEG encoder with quantize and entropy pack on a
    torch ``device``. Output bytes equal the JAX package's for the same
    options."""

    def __init__(self, width: int, height: int, quality: int = 85,
                 sampling: str = "444", restart_interval_rows: int = 0, *,
                 device, counters: EncodeCounters | None = None, mesh: Mesh | None = None):
        if width < 1 or height < 1:
            raise StitchError(f"Invalid JPEG dimensions: {width}x{height}")
        if not (1 <= quality <= 100):
            raise StitchError("JPEG quality must be between 1 and 100")
        if sampling not in ("444", "420"):
            raise StitchError(f"Unsupported JPEG sampling: {sampling}")
        if restart_interval_rows < 0:
            raise StitchError("restart_interval_rows must be >= 0")
        self.width = width
        self.height = height
        self.quality = quality
        self.sampling = sampling
        # 4:2:0 MCUs are 16x16 px; strips and padding work in MCU heights.
        self._mcu_h = 16 if sampling == "420" else MCU_HEIGHT
        self.luma_q, self.chroma_q = quality_scaled_tables(quality)
        self._dc_luma = build_huffman_codes(STD_DC_LUMA_BITS, STD_DC_LUMA_VALS)
        self._ac_luma = build_huffman_codes(STD_AC_LUMA_BITS, STD_AC_LUMA_VALS)
        self._dc_chroma = build_huffman_codes(STD_DC_CHROMA_BITS, STD_DC_CHROMA_VALS)
        self._ac_chroma = build_huffman_codes(STD_AC_CHROMA_BITS, STD_AC_CHROMA_VALS)
        # Restart markers every `restart_interval_rows` MCU rows (T.81
        # B.2.4.4): each group's bitstream is byte-aligned and DC-reset, so
        # groups entropy-code independently — the unit of parallel encode.
        self._restart_rows = int(restart_interval_rows)
        _mcu_px = 16 if sampling == "420" else 8
        self._mcus_per_row = (width + ((-width) % _mcu_px)) // _mcu_px
        self._header_emitted = False
        self._finished = False
        self._pending = None  # buffered rows < mcu height: array or tensor
        self._pad_w = (-width) % (16 if sampling == "420" else 8)
        # Device pipeline depth: submissions in flight before the oldest is
        # drained. Depth >1 overlaps host decode/assembly of later bands
        # with the link transfer + device compute of earlier ones (restart
        # groups carry no inter-band state, so depth is free).
        self._inflight = collections.deque()
        self._inflight_depth = max(1, int(os.environ.get("STITCH_TPU_INFLIGHT", "2")))
        self._dev_encoder = TorchJpegEncoder(
            self.luma_q, self.chroma_q,
            self._dc_luma, self._ac_luma, self._dc_chroma, self._ac_chroma,
            device=device,
            restart_interval_rows=self._restart_rows,
            sampling=sampling,
            local_words=local_words_for_quality(quality),
            counters=counters,
            mesh=mesh,
        )

    # ----- headers ------------------------------------------------------ #

    def _header_bytes(self) -> bytes:
        out = bytearray()
        out += b"\xff\xd8"  # SOI
        # APP0 JFIF
        out += b"\xff\xe0" + (16).to_bytes(2, "big")
        out += b"JFIF\x00" + bytes([1, 1, 0]) + (1).to_bytes(2, "big") + (1).to_bytes(
            2, "big"
        ) + bytes([0, 0])
        # DQT x2 (zigzag order payload)
        for tid, q in ((0, self.luma_q), (1, self.chroma_q)):
            out += b"\xff\xdb" + (67).to_bytes(2, "big") + bytes([tid])
            out += bytes(int(v) for v in q[ZIGZAG])  # table in zigzag order
        # SOF0: baseline, 3 components (sampling per self.sampling)
        out += b"\xff\xc0" + (17).to_bytes(2, "big") + bytes([8])
        out += self.height.to_bytes(2, "big") + self.width.to_bytes(2, "big")
        out += bytes([3])
        y_hv = 0x22 if self.sampling == "420" else 0x11
        out += bytes([1, y_hv, 0])  # Y
        out += bytes([2, 0x11, 1])  # Cb
        out += bytes([3, 0x11, 1])  # Cr
        # DHT x4
        for tc_th, bits, vals in (
            (0x00, STD_DC_LUMA_BITS, STD_DC_LUMA_VALS),
            (0x10, STD_AC_LUMA_BITS, STD_AC_LUMA_VALS),
            (0x01, STD_DC_CHROMA_BITS, STD_DC_CHROMA_VALS),
            (0x11, STD_AC_CHROMA_BITS, STD_AC_CHROMA_VALS),
        ):
            payload = bytes([tc_th]) + bytes(bits[1:17]) + bytes(vals)
            out += b"\xff\xc4" + (2 + len(payload)).to_bytes(2, "big") + payload
        # DRI (restart interval in MCUs, T.81 B.2.4.4)
        if self._restart_rows:
            dri = self._restart_rows * self._mcus_per_row
            if dri > 0xFFFF:
                raise StitchError(
                    f"Restart interval {dri} MCUs exceeds the 16-bit DRI "
                    f"field; lower jpeg_restart_interval_rows"
                )
            out += b"\xff\xdd" + (4).to_bytes(2, "big") + dri.to_bytes(2, "big")
        # SOS
        out += b"\xff\xda" + (12).to_bytes(2, "big") + bytes([3])
        out += bytes([1, 0x00, 2, 0x11, 3, 0x11])
        out += bytes([0, 63, 0])
        return bytes(out)

    def header(self) -> Iterator[bytes]:
        """Yields nothing: SOI+headers ride the first strip, matching the
        reference's WASM behavior (jpeg-encoder.ts:123-152)."""
        return iter(())

    # ----- strips ------------------------------------------------------- #

    def encode_band(self, band) -> Iterator[bytes]:
        """Consume an (h, W, 4) uint8 band, a host array or a tensor on the
        encoder's device (a tensor elsewhere raises), or a ``ShardedBand``;
        yields encoded bytes. A packed (h, W) uint32 band is taken as its
        uint8 view, so held-back rows always join in that form."""
        if self._finished:
            raise StitchError("JPEG encoder already finished")
        band = unpack_rgba(band)
        # A ShardedBand of whole restart groups goes to the shards as it
        # lies; any other is joined on the mesh's first device.
        group_rows = self._restart_rows * self._mcu_h
        if isinstance(band, ShardedBand) and (
                not group_rows or self._pending is not None or band.shape[0] % group_rows):
            band = self._dev_encoder.on_device(band)
        if isinstance(band, torch.Tensor):
            band = self._dev_encoder.on_device(band)
        elif not isinstance(band, ShardedBand):
            band = np.asarray(band, dtype=np.uint8)
        if band.shape[1] != self.width:
            raise StitchError(
                f"Band width {band.shape[1]} != encoder width {self.width}"
            )
        if not self._header_emitted:
            self._header_emitted = True
            yield self._header_bytes()
        if self._pending is not None:
            band = self._join(self._pending, band)
            self._pending = None
        # With restarts, submit whole restart groups only (groups pack
        # independently on device; a shorter group is legal only as the
        # image tail, handled in finish()).
        unit = self._mcu_h
        if self._restart_rows:
            unit = self._restart_rows * self._mcu_h
        n_units = band.shape[0] // unit
        n_full = n_units * (unit // self._mcu_h)
        if n_full:
            full = band if isinstance(band, ShardedBand) else band[: n_full * self._mcu_h]
            # One-band lookahead: submit this band (device computes + packs
            # bits), emit the previous band's bytes meanwhile.
            if self._pad_w:
                full = _repeat_edge(full, self._pad_w, axis=1)
            self._inflight.append(self._dev_encoder.submit(full))
            while len(self._inflight) > self._inflight_depth:
                data = self._dev_encoder.wait(self._inflight.popleft())
                if data:
                    yield data
        if isinstance(band, ShardedBand):
            return
        rest = band[n_full * self._mcu_h :]
        if rest.shape[0]:
            # A tensor's rows are a view: nothing writes to a submitted band.
            self._pending = rest.copy() if isinstance(rest, np.ndarray) else rest

    def encode_strip_bytes(self, strip_rgba: bytes | np.ndarray) -> Iterator[bytes]:
        """Reference-shaped API: raw RGBA strip bytes of <=8 rows
        (jpeg-encoder.ts:155-172)."""
        arr = np.frombuffer(bytes(strip_rgba), dtype=np.uint8)
        rows = arr.size // (self.width * 4)
        yield from self.encode_band(arr.reshape(rows, self.width, 4))

    def _join(self, pending, band):
        """Held-back rows, then the band: on the host when both are host
        arrays, else on the device (alpha dropped: JPEG ignores it)."""
        if isinstance(pending, np.ndarray) and isinstance(band, np.ndarray):
            return np.concatenate([pending, band], axis=0)
        parts = [self._dev_encoder.on_device(a)[..., :3] for a in (pending, band)]
        return torch.cat(parts, dim=0)

    def finish(self) -> Iterator[bytes]:
        """Pad any partial final strip with edge-row repetition, flush bits,
        emit EOI (jpeg-encoder.ts:157-190)."""
        if self._finished:
            return
        self._finished = True
        out = bytearray()
        if not self._header_emitted:
            self._header_emitted = True
            out += self._header_bytes()
        part = None
        if self._pending is not None and self._pending.shape[0]:
            part = self._pending
            self._pending = None
            # Pending may exceed one MCU strip in restart mode (group-aligned
            # holdback); pad to the next MCU-height multiple.
            pad_rows = (-part.shape[0]) % self._mcu_h
            if pad_rows:
                part = _repeat_edge(part, pad_rows, axis=0)
        # Drain the device pipeline; the padded partial strip goes through
        # the same device path so the carry chain stays on device.
        if part is not None:
            if self._pad_w:
                part = _repeat_edge(part, self._pad_w, axis=1)
            self._inflight.append(self._dev_encoder.submit(part))
        while self._inflight:
            out += self._dev_encoder.wait(self._inflight.popleft())
        out += self._dev_encoder.flush()
        out += b"\xff\xd9"  # EOI
        yield bytes(out)


def _band_to_blocks_numpy(
    band_rgba: np.ndarray, luma_q: np.ndarray, chroma_q: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(8k, W, 4) uint8 -> three (k*W/8, 64) int16 quantized natural-order
    blocks in strip-major order.

    Host oracle path: the exact integer pipeline (ops/jpeg_dct), run in
    torch on the CPU, so every tier — this one, the card, C++ — produces
    bit-identical quantized coefficients by construction.
    """
    h, w = band_rgba.shape[:2]
    assert h % MCU_HEIGHT == 0 and w % 8 == 0
    return _blocks_on_cpu(band_to_blocks_islow, band_rgba, luma_q, chroma_q)


def _band_to_blocks_numpy_420(
    band_rgba: np.ndarray, luma_q: np.ndarray, chroma_q: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """4:2:0 quantization: full-res Y, 2x2 box-averaged integer chroma.

    band: (16k, W, 4) uint8 with W % 16 == 0. Returns (y (4n, 64) in MCU
    order [TL,TR,BL,BR], cb (n, 64), cr (n, 64)) with n MCUs raster-major.
    """
    h, w = band_rgba.shape[:2]
    assert h % 16 == 0 and w % 16 == 0
    return _blocks_on_cpu(band_to_blocks_islow_420, band_rgba, luma_q, chroma_q)


def _blocks_on_cpu(fn, band_rgba: np.ndarray, luma_q: np.ndarray, chroma_q: np.ndarray):
    """``fn`` (a plain torch quantize of ops/jpeg_dct) on CPU tensors over
    host arrays; the blocks come back as host arrays."""
    tables = (torch.from_numpy(np.asarray(q, dtype=np.int32)) for q in (luma_q, chroma_q))
    blocks = fn(torch.from_numpy(np.ascontiguousarray(band_rgba, dtype=np.uint8)), *tables)
    return tuple(b.numpy() for b in blocks)


class StreamingJpegEncoder:
    """Band-level streaming encoder of the host tier, used by the
    orchestrator under ``backend="numpy"``; ``counters.host_tier_bands``
    counts the bands it is handed."""

    def __init__(
        self,
        width: int,
        height: int,
        quality: int = 85,
        sampling: str = "444",
        restart_interval_rows: int = 0,
        *,
        counters: EncodeCounters | None = None,
    ):
        if width < 1 or height < 1:
            raise StitchError(f"Invalid JPEG dimensions: {width}x{height}")
        if not (1 <= quality <= 100):
            raise StitchError("JPEG quality must be between 1 and 100")
        if sampling not in ("444", "420"):
            raise StitchError(f"Unsupported JPEG sampling: {sampling}")
        if restart_interval_rows < 0:
            raise StitchError("restart_interval_rows must be >= 0")
        self.width = width
        self.height = height
        self.quality = quality
        self.sampling = sampling
        self.counters = counters if counters is not None else EncodeCounters()
        # 4:2:0 MCUs are 16x16 px; strips and padding work in MCU heights.
        self._mcu_h = 16 if sampling == "420" else MCU_HEIGHT
        self.luma_q, self.chroma_q = quality_scaled_tables(quality)
        self._dc_luma = build_huffman_codes(STD_DC_LUMA_BITS, STD_DC_LUMA_VALS)
        self._ac_luma = build_huffman_codes(STD_AC_LUMA_BITS, STD_AC_LUMA_VALS)
        self._dc_chroma = build_huffman_codes(STD_DC_CHROMA_BITS, STD_DC_CHROMA_VALS)
        self._ac_chroma = build_huffman_codes(STD_AC_CHROMA_BITS, STD_AC_CHROMA_VALS)
        self._enc_luma = HuffmanEncoder(self._dc_luma, self._ac_luma)
        self._enc_chroma = HuffmanEncoder(self._dc_chroma, self._ac_chroma)
        self._packer = BitPacker()
        # Native entropy tier (C++): the serial bitstream stage; falls back
        # to the vectorized-numpy packer when the toolchain is unavailable.
        self._native_coder = None
        if native_available():
            self._native_coder = NativeEntropyCoder(
                make_huff_table(self._dc_luma, self._ac_luma),
                make_huff_table(self._dc_chroma, self._ac_chroma),
                sampling=sampling,
            )
        if self._native_coder is None and width * height > (1 << 21):
            import warnings

            # The numpy symbol generator walks blocks in Python — correct
            # (it is the oracle) but ~1-2 MP/s. Say so instead of silently
            # crawling (round-1 review finding).
            warnings.warn(
                "Native JPEG entropy coder unavailable (no C++ toolchain?): "
                "falling back to the Python oracle coder, which is ~50-100x "
                "slower. Install g++ or use backend='torch'.",
                RuntimeWarning,
                stacklevel=3,
            )
        self._prev_dc = [0, 0, 0]
        # Restart markers every `restart_interval_rows` MCU rows (T.81
        # B.2.4.4): each group's bitstream is byte-aligned and DC-reset, so
        # groups entropy-code independently — the unit of parallel encode.
        self._restart_rows = int(restart_interval_rows)
        _mcu_px = 16 if sampling == "420" else 8
        self._mcus_per_row = (width + ((-width) % _mcu_px)) // _mcu_px
        self._mcu_rows_done = 0
        self._rst_n = 0
        self._header_emitted = False
        self._finished = False
        self._rows_consumed = 0
        self._pending: np.ndarray | None = None  # buffered rows < mcu height
        self._pad_w = (-width) % (16 if sampling == "420" else 8)

    # The headers and the strip-bytes entry are the torch encoder's: they
    # read only attributes both classes set alike.
    _header_bytes = TorchStreamingJpegEncoder._header_bytes
    header = TorchStreamingJpegEncoder.header
    encode_strip_bytes = TorchStreamingJpegEncoder.encode_strip_bytes

    # ----- strips ------------------------------------------------------- #

    def _quantize_band(self, band: np.ndarray):
        """Pad width to an MCU multiple (edge repetition) and quantize the
        whole multi-strip band in one native host call."""
        if self._pad_w:
            band = np.concatenate(
                [band, np.repeat(band[:, -1:, :], self._pad_w, axis=1)], axis=1
            )
        # The native calls return None when the C++ library is absent.
        if self.sampling == "420":
            native = jpeg_quant_band_420_native(band, self.luma_q, self.chroma_q)
            if native is not None:
                return native
            return _band_to_blocks_numpy_420(band, self.luma_q, self.chroma_q)
        native = jpeg_quant_band_native(band, self.luma_q, self.chroma_q)
        if native is not None:
            return native
        return _band_to_blocks_numpy(band, self.luma_q, self.chroma_q)

    def _entropy_code(self, yb, cbb, crb) -> bytes:
        """Huffman-encode quantized blocks (any number of strips).

        For 4:2:0, ``yb`` is in MCU order (4 Y blocks per chroma block)."""
        if self._native_coder is not None:
            return self._native_coder.encode(yb, cbb, crb)
        yc, yl, self._prev_dc[0] = self._enc_luma.encode_component_blocks(
            yb, self._prev_dc[0]
        )
        cbc, cbl, self._prev_dc[1] = self._enc_chroma.encode_component_blocks(
            cbb, self._prev_dc[1]
        )
        crc, crl, self._prev_dc[2] = self._enc_chroma.encode_component_blocks(
            crb, self._prev_dc[2]
        )
        if self.sampling == "420":
            codes_parts, lens_parts = [], []
            for m in range(cbb.shape[0]):
                for j in range(4):
                    codes_parts.append(yc[m * 4 + j])
                    lens_parts.append(yl[m * 4 + j])
                codes_parts.append(cbc[m])
                lens_parts.append(cbl[m])
                codes_parts.append(crc[m])
                lens_parts.append(crl[m])
            codes = np.concatenate(codes_parts)
            lens = np.concatenate(lens_parts)
        else:
            codes, lens = interleave_mcus([(yc, yl), (cbc, cbl), (crc, crl)])
        return self._packer.pack(codes, lens)

    def _fused_native_band(self, band) -> bytes | None:
        """Fused native convert+FDCT+quantize+entropy for a whole band (one
        DRAM pass; blocks stay strip-local in L2). Byte stream identical to
        the split quantize->entropy path. With restart markers on, the fused
        call runs per restart GROUP (groups are byte-aligned and DC-reset,
        so per-group fused encode + the shared _restart_boundary
        bookkeeping reproduces the split path's bytes exactly). None =
        inapplicable (caller falls back)."""
        if self._native_coder is None or not isinstance(band, np.ndarray):
            return None
        if self._pad_w:
            band = np.concatenate(
                [band, np.repeat(band[:, -1:, :], self._pad_w, axis=1)], axis=1
            )
        if not self._restart_rows:
            data = self._native_coder.encode_rgba_band(
                band, self.luma_q, self.chroma_q
            )
            if data is None:
                return None
            self._rows_consumed += band.shape[0]
            self._mcu_rows_done += band.shape[0] // self._mcu_h
            return data
        # Restart path: the applicability conditions of encode_rgba_band
        # (native lib present, dims MCU-aligned) are invariant across the
        # group chunks below, so probe them on the FIRST chunk only — a
        # None mid-band would otherwise leave half a band emitted.
        ri = self._restart_rows
        mh = self._mcu_h
        h = band.shape[0]
        parts = []
        row = 0
        while row < h:
            boundary = self._restart_boundary()
            rows_left_in_group = ri - (self._mcu_rows_done % ri)
            take = min(rows_left_in_group * mh, h - row)
            data = self._native_coder.encode_rgba_band(
                band[row : row + take], self.luma_q, self.chroma_q
            )
            if data is None:
                if row == 0:
                    return None
                raise StitchError(
                    "fused JPEG tier became unavailable mid-band"
                )  # pragma: no cover - conditions are chunk-invariant
            parts.append(boundary + data)
            self._rows_consumed += take
            self._mcu_rows_done += take // mh
            row += take
        return b"".join(parts)

    def _encode_strip(self, strip: np.ndarray) -> bytes:
        """Encode one full MCU strip to entropy-coded bytes."""
        data = self._fused_native_band(strip)
        if data is not None:
            return data
        yb, cbb, crb = self._quantize_band(strip)
        return b"".join(self._emit_blocks(yb, cbb, crb))

    def _restart_boundary(self) -> bytes:
        """Bytes closing the current restart group, if one ends here: pad the
        bitstream to a byte with 1s, emit RSTn (cycling 0-7), reset DC
        predictors (T.81 E.2.4). Empty when restarts are off or mid-group."""
        ri = self._restart_rows
        if not ri or self._mcu_rows_done == 0 or self._mcu_rows_done % ri:
            return b""
        if self._native_coder is not None:
            out = self._native_coder.flush()
            self._native_coder.reset()
        else:
            out = self._packer.flush()
            self._prev_dc = [0, 0, 0]
        out += bytes([0xFF, 0xD0 + self._rst_n])
        self._rst_n = (self._rst_n + 1) & 7
        return out

    def _emit_blocks(self, yb, cbb, crb) -> Iterator[bytes]:
        """Entropy-code quantized blocks strip-by-strip so bytes stream."""
        if not self._restart_rows and self._native_coder is not None:
            # No restart boundaries to interleave: one native call for the
            # whole band (the per-strip loop below exists only to place
            # RSTn markers between MCU rows).
            mcu_w = 16 if self.sampling == "420" else 8
            mpr = (self.width + self._pad_w) // mcu_w
            n_strips = cbb.shape[0] // mpr
            data = self._entropy_code(yb, cbb, crb)
            self._rows_consumed += self._mcu_h * n_strips
            self._mcu_rows_done += n_strips
            if data:
                yield data
            return
        if self.sampling == "420":
            mpr = (self.width + self._pad_w) // 16  # MCUs per strip row
            n_strips = cbb.shape[0] // mpr
            for i in range(n_strips):
                ysl = slice(i * 4 * mpr, (i + 1) * 4 * mpr)
                csl = slice(i * mpr, (i + 1) * mpr)
                data = self._restart_boundary()
                data += self._entropy_code(yb[ysl], cbb[csl], crb[csl])
                self._rows_consumed += self._mcu_h
                self._mcu_rows_done += 1
                if data:
                    yield data
            return
        bps = (self.width + self._pad_w) // 8  # blocks per strip
        n_strips = yb.shape[0] // bps
        for i in range(n_strips):
            sl = slice(i * bps, (i + 1) * bps)
            data = self._restart_boundary()
            data += self._entropy_code(yb[sl], cbb[sl], crb[sl])
            self._rows_consumed += MCU_HEIGHT
            self._mcu_rows_done += 1
            if data:
                yield data

    def encode_band(self, band: np.ndarray) -> Iterator[bytes]:
        """Consume an (h, W, 4) uint8 host band; yields encoded bytes. A
        tensor raises: a band on a device has no business on the host tier,
        and is not read back behind the caller's back."""
        if self._finished:
            raise StitchError("JPEG encoder already finished")
        if isinstance(band, torch.Tensor):
            raise StitchError(
                f"a tensor band on {band.device} reached the host JPEG encoder "
                "(backend='numpy'); the host tier takes host arrays only"
            )
        if getattr(band, "ndim", None) == 2:
            band = unpack_rgba(np.asarray(band))
        band = np.asarray(band, dtype=np.uint8)
        if band.shape[1] != self.width:
            raise StitchError(
                f"Band width {band.shape[1]} != encoder width {self.width}"
            )
        self.counters.host_tier_bands += 1
        if not self._header_emitted:
            self._header_emitted = True
            yield self._header_bytes()
        if self._pending is not None:
            band = np.concatenate([self._pending, band], axis=0)
            self._pending = None
        n_full = band.shape[0] // self._mcu_h
        if n_full:
            full = band[: n_full * self._mcu_h]
            data = self._fused_native_band(full)
            if data is not None:
                yield data
            else:
                yb, cbb, crb = self._quantize_band(full)
                yield from self._emit_blocks(yb, cbb, crb)
        rest = band[n_full * self._mcu_h :]
        if rest.shape[0]:
            self._pending = rest.copy()

    def finish(self) -> Iterator[bytes]:
        """Pad any partial final strip with edge-row repetition, flush bits,
        emit EOI (jpeg-encoder.ts:157-190)."""
        if self._finished:
            return
        self._finished = True
        out = bytearray()
        if not self._header_emitted:
            self._header_emitted = True
            out += self._header_bytes()
        if self._pending is not None and self._pending.shape[0]:
            part = self._pending
            self._pending = None
            # Pad the held-back rows to the next MCU-height multiple.
            pad_rows = (-part.shape[0]) % self._mcu_h
            if pad_rows:
                part = np.concatenate(
                    [part, np.repeat(part[-1:], pad_rows, axis=0)], axis=0
                )
            out += self._encode_strip(part)
        if self._native_coder is not None:
            out += self._native_coder.flush()
        else:
            out += self._packer.flush()
        out += b"\xff\xd9"  # EOI
        yield bytes(out)


class JpegEncoder:
    """Reference-compatible wrapper class (src/jpeg-encoder.ts:96-245), the
    counterpart of the JAX package's ``JpegEncoder``: one carried stream, no
    restart markers. ``backend`` "torch" (the default), "jax" or "tpu" runs
    ``TorchStreamingJpegEncoder`` on ``device``: "cuda" (raises without a
    card) or "cpu" (the kernels' plain versions). "numpy" or "oracle" runs
    the host tier's ``StreamingJpegEncoder`` and leaves ``device`` unread.
    "auto" takes the auto policy's answer for ``width * height`` pixels
    (``ops.backend.resolve_backend_name``), where the JAX package's
    encoder codes "auto" on the host. Any other name raises."""

    def __init__(self, width: int, height: int, quality: int = 85,
                 backend: str = "torch", sampling: str = "444", *,
                 device="cuda", counters: EncodeCounters | None = None):
        if resolve_backend_name(backend, width * height, device) == "numpy":
            self._inner = StreamingJpegEncoder(
                width, height, quality, sampling, counters=counters)
        else:
            self._inner = TorchStreamingJpegEncoder(
                width, height, quality, sampling,
                device=resolve_device(device), counters=counters,
            )
        self.width = width
        self.height = height
        self.quality = quality

    def header(self) -> Iterator[bytes]:
        return self._inner.header()

    def encode_strip(self, strip: bytes | np.ndarray, _last_scanline=None) -> Iterator[bytes]:
        return self._inner.encode_strip_bytes(strip)

    def finish(self) -> Iterator[bytes]:
        return self._inner.finish()

    def encode_to_buffer(self, rgba: bytes | np.ndarray) -> bytes:
        """Batch helper (reference: encodeToBuffer, jpeg-encoder.ts:199-245)."""
        arr = np.frombuffer(bytes(rgba), dtype=np.uint8).reshape(
            self.height, self.width, 4
        )
        chunks = list(self._inner.encode_band(arr))
        chunks += list(self._inner.finish())
        return b"".join(chunks)


def encode_jpeg(
    rgba: np.ndarray, width: int, height: int, quality: int = 85,
    backend: str = "torch", sampling: str = "444", *,
    device="cuda", counters: EncodeCounters | None = None,
) -> bytes:
    """One-shot encode (reference: encodeJpeg, jpeg-encoder.ts:256-264)."""
    enc = JpegEncoder(width, height, quality, backend, sampling,
                      device=device, counters=counters)
    return enc.encode_to_buffer(np.asarray(rgba, dtype=np.uint8).tobytes())
