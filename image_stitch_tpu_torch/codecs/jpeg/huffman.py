"""JPEG Huffman entropy coding — host-side bitstream packing.

The TPU produces quantized DCT coefficients (see ops/device.py and
codecs/jpeg/encoder.py); this module turns them into the entropy-coded
segment. Counterpart of the entropy coder inside the reference's Rust WASM
encoder (SURVEY §2 native item 1; wrapper src/jpeg-encoder.ts:96-264).

Design: symbol generation walks blocks (numpy-assisted), then a fully
vectorized bit packer expands (code, length) pairs into the byte stream with
0xFF stuffing. The packer carries sub-byte state across strips so encoding
streams in 8-row MCU strips exactly like the reference
(image-concat-core.ts:881-899).
"""

from __future__ import annotations

import numpy as np

from .tables import ZIGZAG, build_huffman_codes


def _bit_size(values: np.ndarray) -> np.ndarray:
    """Number of magnitude bits per value (JPEG 'size' category)."""
    mag = np.abs(values.astype(np.int64))
    # bit_length: 0 -> 0, else floor(log2)+1
    return np.where(mag == 0, 0, np.floor(np.log2(np.maximum(mag, 1))).astype(np.int64) + 1)


class HuffmanEncoder:
    """Encodes interleaved MCU blocks into (code, length) symbol arrays."""

    def __init__(self, dc_codes: dict, ac_codes: dict):
        from .tables import huffman_lut

        self.dc_code, self.dc_len = huffman_lut(dc_codes, 16)
        self.ac_code, self.ac_len = huffman_lut(ac_codes, 256)

    def encode_component_blocks(
        self, blocks: np.ndarray, prev_dc: int
    ) -> tuple[list[np.ndarray], list[np.ndarray], int]:
        """Encode (N, 64) natural-order quantized blocks for one component.

        Returns per-block (codes, lengths) arrays plus the new DC predictor.
        The per-block arrays are later interleaved into MCU order by the
        caller.
        """
        n = blocks.shape[0]
        zz = blocks[:, ZIGZAG]  # (N, 64) in zigzag order
        dc = zz[:, 0].astype(np.int64)
        diffs = np.diff(np.concatenate([[prev_dc], dc]))
        dc_sizes = _bit_size(diffs)
        dc_value_bits = np.where(diffs < 0, diffs + (1 << dc_sizes) - 1, diffs)

        out_codes: list[np.ndarray] = []
        out_lens: list[np.ndarray] = []
        for i in range(n):
            codes: list[int] = []
            lens: list[int] = []
            s = int(dc_sizes[i])
            codes.append(int(self.dc_code[s]))
            lens.append(int(self.dc_len[s]))
            if s:
                codes.append(int(dc_value_bits[i]) & ((1 << s) - 1))
                lens.append(s)
            row = zz[i, 1:]
            nz = np.nonzero(row)[0]
            prev = -1
            for k in nz:
                run = int(k) - prev - 1
                prev = int(k)
                while run > 15:
                    codes.append(int(self.ac_code[0xF0]))  # ZRL
                    lens.append(int(self.ac_len[0xF0]))
                    run -= 16
                v = int(row[k])
                size = int(_bit_size(np.array([v]))[0])
                sym = (run << 4) | size
                codes.append(int(self.ac_code[sym]))
                lens.append(int(self.ac_len[sym]))
                vb = v if v > 0 else v + (1 << size) - 1
                codes.append(vb & ((1 << size) - 1))
                lens.append(size)
            if len(nz) == 0 or int(nz[-1]) != 62:
                codes.append(int(self.ac_code[0x00]))  # EOB
                lens.append(int(self.ac_len[0x00]))
            out_codes.append(np.array(codes, dtype=np.uint32))
            out_lens.append(np.array(lens, dtype=np.uint8))
        new_dc = int(dc[-1]) if n else prev_dc
        return out_codes, out_lens, new_dc


class BitPacker:
    """Vectorized bit packer with cross-call carry and 0xFF byte stuffing."""

    def __init__(self) -> None:
        self._carry_val = 0  # bits not yet flushed (< 8)
        self._carry_n = 0

    def pack(self, codes: np.ndarray, lengths: np.ndarray) -> bytes:
        """Append symbols to the stream; returns complete stuffed bytes."""
        if len(codes) == 0:
            return b""
        lengths = lengths.astype(np.int64)
        total = int(lengths.sum())
        if total == 0:
            return b""
        offsets = np.cumsum(lengths) - lengths
        sym_ids = np.repeat(np.arange(len(codes)), lengths)
        pos = np.arange(total) - np.repeat(offsets, lengths)
        shift = lengths[sym_ids] - 1 - pos
        bits = ((codes.astype(np.uint64)[sym_ids] >> shift.astype(np.uint64)) & 1).astype(
            np.uint8
        )
        if self._carry_n:
            carry_bits = (
                (self._carry_val >> np.arange(self._carry_n - 1, -1, -1)) & 1
            ).astype(np.uint8)
            bits = np.concatenate([carry_bits, bits])
        n_bytes = bits.shape[0] // 8
        rem = bits.shape[0] - n_bytes * 8
        if rem:
            rem_bits = bits[-rem:]
            self._carry_val = int(rem_bits.dot(1 << np.arange(rem - 1, -1, -1)))
            self._carry_n = rem
            bits = bits[:-rem]
        else:
            self._carry_val = 0
            self._carry_n = 0
        if n_bytes == 0:
            return b""
        packed = np.packbits(bits)
        return self._stuff(packed)

    @staticmethod
    def _stuff(packed: np.ndarray) -> bytes:
        """Insert 0x00 after every 0xFF (entropy-coded byte stuffing)."""
        ff = np.nonzero(packed == 0xFF)[0]
        if len(ff) == 0:
            return packed.tobytes()
        return np.insert(packed, ff + 1, 0).tobytes()

    def flush(self) -> bytes:
        """Pad the final partial byte with 1-bits and emit it."""
        if self._carry_n == 0:
            return b""
        pad = 8 - self._carry_n
        byte = (self._carry_val << pad) | ((1 << pad) - 1)
        self._carry_val = 0
        self._carry_n = 0
        if byte == 0xFF:
            return b"\xff\x00"
        return bytes([byte])


def interleave_mcus(
    per_comp: list[tuple[list[np.ndarray], list[np.ndarray]]],
) -> tuple[np.ndarray, np.ndarray]:
    """Interleave per-component per-block symbol arrays into MCU scan order
    (Y, Cb, Cr for 4:4:4; [Y0,Y1,Y2,Y3,Cb,Cr] lists for 4:2:0)."""
    codes: list[np.ndarray] = []
    lens: list[np.ndarray] = []
    n_mcus = len(per_comp[0][0])
    for m in range(n_mcus):
        for comp_codes, comp_lens in per_comp:
            codes.append(comp_codes[m])
            lens.append(comp_lens[m])
    return np.concatenate(codes), np.concatenate(lens)
