"""Streaming PNG decoder yielding raw scanlines in bands.

Counterpart of the reference's ``src/decoders/png-decoder.ts``. Non-interlaced
images decode incrementally: IDAT fragments feed a streaming inflator and
complete rows are defiltered band-at-a-time (reference decodes row-at-a-time,
png-decoder.ts:92-229). Interlaced images are fully inflated then Adam7
deinterlaced (reference: png-decoder.ts:73-90). File inputs stream chunk by
chunk from the file descriptor rather than loading the whole file (reference
PngFileDecoder scans an IDAT chunk table, png-decoder.ts:286-331).

Superset vs the reference: PLTE/tRNS are captured so paletted images decode
(the reference's conversion throws on color type 3).
"""

from __future__ import annotations

import io
import os
from typing import Iterator

import numpy as np

from ...errors import StitchError
from ...io.inflate import StreamingInflator
from ...types import ImageHeader, PngHeader
from ...utils import get_bytes_per_pixel, read_u32be, scanline_byte_length
from ...ops.adam7 import deinterlace_adam7
from ...ops.png_filter import defilter_band
from .parser import parse_header_chunk, validate_signature


def _defilter_units(units, row_bytes, bpp, prev_row):
    """Defilter (h, 1+row_bytes) scanline units to raw rows through the
    fastest tier (native strided path avoids all intermediate copies)."""
    from ...native import defilter_units_native

    out = defilter_units_native(units, row_bytes, bpp, prev_row)
    if out is not None:
        return out
    block = units.copy()
    return defilter_band(block[:, 0], block[:, 1:], prev_row, bpp)

DEFAULT_BAND_HEIGHT = 256


class PngDecoder:
    """Decodes PNG from a byte buffer or a readable binary stream."""

    format = "png"
    # Every yielded band is a fresh array (defilter allocates per call) or a
    # never-mutated slice (interlaced full-frame decode), so RowSource may
    # alias bands instead of copying (core.py RowSource._pull).
    bands_are_owned = True

    def __init__(self, source, band_height: int | None = None,
                 verify_crc: bool | None = None):
        # verify_crc: strict per-chunk CRC checking while streaming.
        # None = match the reference's per-source posture: buffer inputs
        # verify (PngBufferDecoder routes through parsePngChunks, which
        # CRC-checks every chunk — png-parser.ts:57-64, png-decoder.ts:359);
        # file/stream inputs skip (its fd chunk scan also skips CRC) for
        # throughput. Pass an explicit bool to override either default.
        self._verify_crc = verify_crc  # resolved after source classification
        self._band_height = band_height or DEFAULT_BAND_HEIGHT
        self._closed = False
        self._owns_stream = False
        self._buf: memoryview | None = None
        if isinstance(source, (bytes, bytearray, memoryview, np.ndarray)):
            if isinstance(source, np.ndarray):
                source = source.tobytes()
            data = bytes(source)
            self._buf = memoryview(data)
            # Buffer sources never touch the stream machinery (_walk_buffer
            # handles the whole chunk walk); a None placeholder avoids a
            # BytesIO copy per decoder (visible on many-tiny-tile loads).
            self._stream: io.BufferedIOBase | None = None
            self._owns_stream = False
        elif isinstance(source, (str, os.PathLike)):
            self._stream = open(source, "rb")
            self._owns_stream = True
        elif hasattr(source, "read"):
            self._stream = source
        else:
            raise StitchError(f"Unsupported PNG source type: {type(source).__name__}")
        if self._verify_crc is None:
            self._verify_crc = self._buf is not None
        self._header: PngHeader | None = None
        self._palette: np.ndarray | None = None
        self._trns: np.ndarray | None = None
        self._idat_started = False
        self._pre_idat_done = False
        self._scan_exhausted = False

    # -- header -------------------------------------------------------------

    def _read_exact(self, n: int) -> bytes:
        data = self._stream.read(n)
        if data is None or len(data) != n:
            raise StitchError(
                f"Truncated PNG: expected {n} bytes, got {0 if data is None else len(data)}"
            )
        return data

    @staticmethod
    def _check_crc(ctype: bytes, data: bytes, crc: bytes) -> None:
        from ...utils import png_crc32, read_u32be

        computed = png_crc32(data, png_crc32(ctype))
        expected = read_u32be(crc, 0)
        if computed != expected:
            raise StitchError(
                f"CRC mismatch in chunk '{ctype.decode('ascii', 'replace')}': "
                f"expected {expected:#010x}, got {computed:#010x}"
            )

    def _walk_buffer(self) -> None:
        """Single-pass chunk walk over an in-memory source: captures IHDR/
        PLTE/tRNS and the IDAT payload spans with pure offset arithmetic.
        The stream-based walk costs thousands of tiny read() calls on
        many-chunk files (pngsuite tiles average ~8 chunks); this is one
        function call per image. Same validation and error text."""
        from struct import unpack_from

        buf = self._buf
        assert buf is not None
        n = len(buf)
        validate_signature(bytes(buf[:8]) if n >= 8 else bytes(buf))
        pos = 8
        spans: list[memoryview] = []
        idat_started = False
        while True:
            if pos + 8 > n:
                if idat_started:
                    break  # tolerate missing IEND like a stream EOF
                raise StitchError(
                    f"Truncated PNG: expected 8 bytes, got {max(0, n - pos)}"
                )
            # One unpack for length+type (two slice objects per chunk were
            # measurable on many-tiny-tile loads: pngsuite averages ~8
            # chunks per 32x32 tile).
            length, ctype = unpack_from(">I4s", buf, pos)
            data_start = pos + 8
            data_end = data_start + length
            if ctype == b"IDAT":
                # IDAT-phase problems (truncation, bad CRC) are deferred
                # to scan time, like the streaming walk — pass 1 (headers)
                # must not fail on pixel-phase corruption, so the
                # orchestrator can attribute the error to its input.
                if data_end > n:
                    idat_started = True
                    self._idat_defer = StitchError(
                        "Truncated PNG: IDAT data incomplete"
                    )
                    break
                if data_end + 4 > n:
                    idat_started = True
                    if length:
                        spans.append(buf[data_start:data_end])
                    self._idat_defer = StitchError(
                        f"Truncated PNG: expected 4 bytes, got {n - data_end}"
                    )
                    break
                idat_started = True
                if length:
                    spans.append(buf[data_start:data_end])
                if self._verify_crc:
                    try:
                        # memoryview slices: no per-chunk bytes copies on
                        # the (large) IDAT payloads.
                        self._check_crc(
                            ctype, buf[data_start:data_end],
                            bytes(buf[data_end : data_end + 4]),
                        )
                    except StitchError as exc:
                        self._idat_defer = exc
                        break
                pos = data_end + 4
                continue
            if idat_started:
                break  # first non-IDAT chunk ends the scan data
            if data_end > n:
                raise StitchError(
                    f"Truncated PNG: expected {length} bytes, got {n - data_start}"
                )
            if data_end + 4 > n:
                raise StitchError(
                    f"Truncated PNG: expected 4 bytes, got {n - data_end}"
                )
            data = bytes(buf[data_start:data_end])
            if self._verify_crc:
                self._check_crc(ctype, data, bytes(buf[data_end : data_end + 4]))
            if ctype == b"IHDR":
                self._header = parse_header_chunk(data)
            elif ctype == b"PLTE":
                if len(data) % 3 != 0:
                    raise StitchError(f"PLTE length {len(data)} not a multiple of 3")
                self._palette = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3).copy()
            elif ctype == b"tRNS":
                self._trns = np.frombuffer(data, dtype=np.uint8).copy()
            elif ctype == b"IEND":
                raise StitchError("PNG has no IDAT chunk")
            pos = data_end + 4
        if not idat_started:
            raise StitchError("PNG has no IDAT chunk")
        if self._header is None:
            raise StitchError("PNG missing IHDR chunk")
        self._idat_started = True
        self._idat_spans: list[memoryview] | None = spans
        self._pre_idat_done = True

    _idat_defer: StitchError | None = None

    def _read_pre_idat(self) -> None:
        """Walk chunks up to (not including) the first IDAT, capturing IHDR,
        PLTE and tRNS. Leaves the stream positioned at the first IDAT header."""
        if self._pre_idat_done:
            return
        if self._buf is not None:
            self._walk_buffer()
            return
        self._idat_spans = None
        validate_signature(self._read_exact(8))
        while True:
            head = self._read_exact(8)
            length = read_u32be(head, 0)
            ctype = head[4:8]
            if ctype == b"IDAT":
                self._pending_idat_header = (length,)
                self._idat_started = True
                break
            data = self._read_exact(length)
            crc = self._read_exact(4)
            if self._verify_crc:
                self._check_crc(ctype, data, crc)
            if ctype == b"IHDR":
                self._header = parse_header_chunk(data)
            elif ctype == b"PLTE":
                if len(data) % 3 != 0:
                    raise StitchError(f"PLTE length {len(data)} not a multiple of 3")
                self._palette = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3).copy()
            elif ctype == b"tRNS":
                self._trns = np.frombuffer(data, dtype=np.uint8).copy()
            elif ctype == b"IEND":
                raise StitchError("PNG has no IDAT chunk")
        if self._header is None:
            raise StitchError("PNG missing IHDR chunk")
        self._pre_idat_done = True

    def get_header(self) -> ImageHeader:
        self._read_pre_idat()
        h = self._header
        assert h is not None
        channels = {0: 1, 2: 3, 3: 3, 4: 2, 6: 4}[h.color_type]
        meta: dict = {"png_header": h}
        if self._palette is not None:
            meta["palette"] = self._palette
        if self._trns is not None:
            meta["trns"] = self._trns
        return ImageHeader(
            width=h.width,
            height=h.height,
            channels=channels,
            bit_depth=h.bit_depth,
            format="png",
            metadata=meta,
        )

    @property
    def png_header(self) -> PngHeader:
        self._read_pre_idat()
        assert self._header is not None
        return self._header

    # -- pixel data ---------------------------------------------------------

    def _iter_idat(self) -> Iterator[bytes]:
        """Yield raw IDAT payload fragments, streaming from the source."""
        self._read_pre_idat()
        if not self._idat_started:
            return
        if getattr(self, "_idat_spans", None) is not None:
            yield from self._idat_spans
            if self._idat_defer is not None:
                raise self._idat_defer
            return
        (length,) = self._pending_idat_header
        import zlib as _zlib

        while True:
            # Stream current IDAT payload in bounded pieces.
            remaining = length
            running = _zlib.crc32(b"IDAT") if self._verify_crc else 0
            while remaining > 0:
                piece = self._stream.read(min(remaining, 1 << 16))
                if not piece:
                    raise StitchError("Truncated PNG: IDAT data incomplete")
                remaining -= len(piece)
                if self._verify_crc:
                    running = _zlib.crc32(piece, running)
                yield piece
            crc = self._read_exact(4)
            if self._verify_crc:
                if (running & 0xFFFFFFFF) != read_u32be(crc, 0):
                    raise StitchError(
                        f"CRC mismatch in IDAT chunk: expected "
                        f"{read_u32be(crc, 0):#010x}, got {running & 0xFFFFFFFF:#010x}"
                    )
            head = self._stream.read(8)
            if head is None or len(head) < 8:
                return  # tolerate missing IEND like a stream EOF
            length = read_u32be(head, 0)
            ctype = head[4:8]
            if ctype != b"IDAT":
                # Skip/stop at first non-IDAT chunk (IEND etc.).
                return

    def bands(self, band_height: int | None = None) -> Iterator[np.ndarray]:
        """Yield (h, row_bytes) uint8 bands of raw (defiltered) scanlines."""
        if self._scan_exhausted:
            raise StitchError("PNG decoder scanlines already consumed")
        self._scan_exhausted = True
        band_height = band_height or self._band_height
        header = self.png_header
        row_bytes = scanline_byte_length(header.width, header.bit_depth, header.color_type)
        bpp = get_bytes_per_pixel(header.bit_depth, header.color_type)
        unit = 1 + row_bytes

        if header.interlace_method == 1:
            # Interlaced: full inflate then Adam7 (reference: png-decoder.ts:73-90).
            inflator = StreamingInflator(strict=self._verify_crc)
            if hasattr(inflator, "drain_into"):
                # One-shot: the total decompressed size is known from the
                # pass layout, so feed everything and decode straight into
                # one buffer (no per-fragment bytes churn — interlaced
                # images are small by construction of this path).
                from ...ops.adam7 import ADAM7_PASSES, get_pass_dimensions

                total = 0
                for p in ADAM7_PASSES:
                    pw, ph = get_pass_dimensions(header.width, header.height, p)
                    if pw and ph:
                        total += ph * (1 + scanline_byte_length(
                            pw, header.bit_depth, header.color_type))
                out = np.empty(total + 1, dtype=np.uint8)
                for c in self._iter_idat():
                    inflator.feed(c)
                fill = 0
                while True:
                    n = inflator.drain_into(out[fill:])
                    if n == 0:
                        break
                    fill += n
                inflator.verify_finished()
                if fill != total:
                    raise StitchError(
                        f"Interlaced PNG decompressed to {fill} bytes; "
                        f"expected {total}"
                    )
                raw = deinterlace_adam7(out[:total], header)
            else:
                parts = [inflator.push(c) for c in self._iter_idat()]
                parts.append(inflator.finish())
                raw = deinterlace_adam7(b"".join(parts), header)
            for y0 in range(0, header.height, band_height):
                yield raw[y0 : y0 + band_height]
            return

        inflator = StreamingInflator(strict=self._verify_crc)
        rows_done = 0
        prev_row: np.ndarray | None = None

        if hasattr(inflator, "drain_into"):
            # Zero-copy path (owned C++ inflate): decode straight into a
            # band-sized scanline-unit scratch, defilter from it — no
            # intermediate bytes objects or bytearray churn.
            take_rows = min(band_height, header.height)
            cap = take_rows * unit
            from ...native import buffer_pool

            scratch = buffer_pool.get(cap)
            fill = 0

            def emit(final: bool):
                nonlocal fill, rows_done, prev_row
                take = min(fill // unit, band_height, header.height - rows_done)
                if take == 0:
                    return None
                if not final and take < band_height and rows_done + take < header.height:
                    return None
                band = _defilter_units(
                    scratch[: take * unit].reshape(take, unit),
                    row_bytes, bpp, prev_row,
                )
                rest = fill - take * unit
                if rest:
                    scratch[:rest] = scratch[take * unit : fill]
                fill = rest
                prev_row = band[-1]
                rows_done += take
                return band

            try:
                # Single-band images feed every fragment first and drain
                # once below; draining per fragment costs a ctypes round
                # trip each on multi-IDAT files (pngsuite-style tiles).
                small = header.height <= band_height
                for fragment in self._iter_idat():
                    inflator.feed(fragment)
                    if small or inflator.finished:
                        continue
                    while True:
                        n = inflator.drain_into(scratch[fill:])
                        fill += n
                        if fill < cap:
                            break  # output not filled => input-limited/done
                        band = emit(final=False)
                        if band is None:
                            # Full scratch but nothing emittable: the image's
                            # rows are complete and the stream still produces
                            # decompressed data (reference residual check,
                            # png-decoder.ts:218-228).
                            raise StitchError(
                                f"Unexpected residual decompressed bytes "
                                f"after {rows_done} scanlines"
                            )
                        yield band
                while True:
                    n = inflator.drain_into(scratch[fill:])
                    if n == 0:
                        break
                    fill += n
                    if fill >= cap:
                        band = emit(final=False)
                        if band is None:
                            raise StitchError(
                                f"Unexpected residual decompressed bytes "
                                f"after {rows_done} scanlines"
                            )
                        yield band
                inflator.verify_finished()
                while True:
                    band = emit(final=True)
                    if band is None:
                        break
                    yield band
                if rows_done < header.height:
                    raise StitchError(
                        f"Expected {header.height} scanlines, got {rows_done}"
                    )
                if fill > 0:
                    raise StitchError(
                        f"Unexpected {fill} residual decompressed bytes "
                        f"after {rows_done} scanlines"
                    )
                return
            finally:
                buffer_pool.put(scratch)
                scratch = None

        buf = bytearray()

        def drain(final: bool) -> Iterator[np.ndarray]:
            nonlocal rows_done, prev_row
            while rows_done < header.height:
                avail_rows = len(buf) // unit
                if avail_rows == 0:
                    return
                take = min(avail_rows, band_height, header.height - rows_done)
                if not final and take < band_height and rows_done + take < header.height:
                    # Wait for a fuller band unless the stream is ending.
                    if avail_rows < band_height:
                        return
                band = _defilter_units(
                    np.frombuffer(
                        memoryview(buf), dtype=np.uint8, count=take * unit
                    ).reshape(take, unit),
                    row_bytes,
                    bpp,
                    prev_row,
                )
                del buf[: take * unit]
                prev_row = band[-1]
                rows_done += take
                yield band

        for fragment in self._iter_idat():
            buf.extend(inflator.push(fragment))
            yield from drain(final=False)
        buf.extend(inflator.finish())
        yield from drain(final=True)

        if rows_done < header.height:
            raise StitchError(
                f"Expected {header.height} scanlines, got {rows_done}"
            )
        if len(buf) > 0:
            # Residual decompressed data check (reference: png-decoder.ts:218-228).
            raise StitchError(
                f"Unexpected {len(buf)} residual decompressed bytes after final scanline"
            )

    def scanlines(self) -> Iterator[np.ndarray]:
        """Per-row iterator (reference-compatible contract)."""
        for band in self.bands():
            for row in band:
                yield row

    @property
    def cache_shareable(self) -> bool:
        """True when this decoder can act as the single producer behind a
        shared decode-once cache entry (buffer-backed: no fd to leak if
        the run aborts before exhaustion)."""
        return self._buf is not None and not self._scan_exhausted

    def clone_fresh(self) -> "PngDecoder | None":
        """A fresh decoder sharing this one's immutable parsed structure,
        or None when not clonable (stream-backed, closed, or the probe
        fails here — the caller then constructs normally so errors keep
        their usual surfacing point).

        Buffer-mode only: the buffer, chunk-walk results (header, palette,
        tRNS, IDAT spans, deferred IDAT error) are immutable after
        :meth:`_walk_buffer` and shared by reference; per-instance scan
        state is reset. Used by the factory to dedupe construction and
        header-probe cost when the same path or bytes object appears many
        times in one grid (decoder-factory.ts:216-283 builds per-input
        with no dedup; tiled mega-images repeat a handful of sources)."""
        if self._buf is None or self._closed:
            return None
        if not self._pre_idat_done:
            try:
                self._read_pre_idat()
            except Exception:
                return None
        c = object.__new__(type(self))
        c._verify_crc = self._verify_crc
        c._band_height = self._band_height
        c._closed = False
        c._owns_stream = False
        c._stream = None
        c._buf = self._buf
        c._header = self._header
        c._palette = self._palette
        c._trns = self._trns
        c._idat_started = self._idat_started
        c._pre_idat_done = self._pre_idat_done
        c._scan_exhausted = False
        c._idat_spans = self._idat_spans
        c._idat_defer = self._idat_defer
        return c

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            if self._owns_stream and self._stream is not None:
                self._stream.close()


class PngFileDecoder(PngDecoder):
    """File-path PNG decoder (reference: PngFileDecoder, png-decoder.ts:235)."""

    def __init__(self, path, band_height=None):
        super().__init__(str(path), band_height=band_height)


class PngBufferDecoder(PngDecoder):
    """Byte-buffer PNG decoder (reference: PngBufferDecoder, png-decoder.ts:338)."""

    def __init__(self, data, band_height=None):
        super().__init__(bytes(data), band_height=band_height)


# Blob-analog: file-like objects go straight to PngDecoder (reference
# PngBlobDecoder, png-decoder.ts:391).
PngBlobDecoder = PngDecoder


def png_plugin():
    """Decoder plugin descriptor (reference: pngDecoder plugin,
    png-decoder.ts:455-472)."""
    from ..registry import DecoderPlugin

    return DecoderPlugin(
        format="png",
        create=lambda source, options=None: PngDecoder(
            source,
            band_height=getattr(options, "band_height", None) if options else None,
            verify_crc=getattr(options, "verify_crc", None) if options else None,
        ),
    )
