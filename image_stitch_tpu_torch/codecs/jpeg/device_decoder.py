"""JPEG band decoder on a torch device: host Huffman once, pixel math per
band on the device.

Counterpart of ``image_stitch_tpu/codecs/jpeg/device_decoder.py``. The
serial entropy stage runs once on the host
(``owned_decoder.decode_coefficients``); per band, each component's window
of zigzag-prefix coefficients goes up as int16 and two kernels do the rest
(``ops/kernels.py``): ``idct_dequant`` (dezigzag, dequantize, islow IDCT,
range limit) once per component, then ``ycc_rgba`` (crop, upsample, colour)
once, writing RGBA straight into the caller's band at the tile's x offset.
On a CPU tensor both run their plain versions (``ops/jpeg_idct_device``).

Upload: the band's zigzag prefix of K coefficients per block, K the image's
highest nonzero zigzag index + 1 rounded up to a multiple of 8. Photo
content at q85-q90 keeps K near 16-40 and chroma subsampled.

Band windowing: h2v2 fancy upsampling reads one row beyond each band edge,
so a component's window holds one extra row on each side that is not an
image edge, and the rows it spoils are cropped after upsampling; the
filter's edge replication then acts only at true image edges, so every
band equals the whole-image decode.
"""

from __future__ import annotations

import numpy as np
import torch

from ...errors import StitchError
from ...ops.kernels import idct_dequant, ycc_rgba
from .owned_decoder import decode_coefficients
from .tables import ZIGZAG


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
        blocks, qtabs, geom, width, height = decode_coefficients(data)
        self.width = width
        self.height = height
        self.device = torch.device(device)
        self._geom = geom  # (by, bx, comp_w, comp_h, h_exp, v_exp) per comp
        self._qtabs = [np.asarray(q, dtype=np.int32) for q in qtabs]
        self._zz_blocks: list[np.ndarray] = []
        self._k: list[int] = []
        self.safe = len(blocks) in (1, 3)
        zz_idx = np.asarray(ZIGZAG)
        zz_pos = np.argsort(zz_idx)  # zigzag position of each natural index
        for b in blocks:
            if b.size and max(int(b.max()), -int(b.min())) >= (1 << 15):
                self.safe = False
            # Image-wide zigzag prefix: K = last nonzero zigzag position + 1,
            # rounded up to a multiple of 8; only those columns are kept
            # (np.take: several times faster than fancy indexing here).
            nz = np.flatnonzero(b.any(axis=0))
            k = int(zz_pos[nz].max()) + 1 if len(nz) else 1
            k = min(64, -(-k // 8) * 8)
            self._k.append(k)
            self._zz_blocks.append(np.take(b, zz_idx[:k], axis=1).astype(np.int16))
        self._dev_q: list[torch.Tensor] | None = None

    def to(self, device) -> "DeviceJpegDecoder":
        """This stream's decoder on ``device``, sharing the host
        coefficients."""
        device = torch.device(device)
        if device == self.device:
            return self
        other = object.__new__(DeviceJpegDecoder)
        other.__dict__.update(self.__dict__)
        other.device = device
        other._dev_q = None
        return other

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(a)
        if self.device.type == "cuda":
            return host.pin_memory().to(self.device, non_blocking=True)
        return host.to(self.device)

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
                    out: torch.Tensor | None = None, x0: int = 0):
        """Decode image rows [y0, y1) to (y1 - y0, width, 4) uint8 RGBA: a
        tensor on the decoder's device when ``return_device``, else a host
        array. With ``out``, an (y1 - y0, W, 4) uint8 tensor on the device,
        the pixels go to its columns [x0, x0 + width) instead, and ``out``
        is returned."""
        windows = self.windows(y0, y1)
        if self._dev_q is None:
            self._dev_q = [self._upload(q) for q in self._qtabs]
        planes = [idct_dequant(self._upload(zz), q, bx)
                  for (zz, bx, _geom), q in zip(windows, self._dev_q)]
        if out is None:
            out = torch.empty((y1 - y0, self.width, 4), dtype=torch.uint8, device=self.device)
            x0 = 0
        ycc_rgba(planes, [geom for _zz, _bx, geom in windows], out, x0, self.width)
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
