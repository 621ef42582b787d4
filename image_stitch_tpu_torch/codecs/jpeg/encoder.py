"""Streaming JPEG encoder whose band program runs in torch.

``TorchStreamingJpegEncoder`` is the JAX package's ``StreamingJpegEncoder``
(image_stitch_tpu/codecs/jpeg/encoder.py) with the device encoder swapped:
headers, strip buffering, edge padding, restart-group alignment, the
in-flight queue (``STITCH_TPU_INFLIGHT``) and ``finish`` are the parent's,
unchanged. The parent only ever hands it host ``np.ndarray`` bands; the
torch encoder uploads them itself.
"""

from __future__ import annotations

from image_stitch_tpu.codecs.jpeg.encoder import StreamingJpegEncoder

from ...ops.counters import EncodeCounters
from ...ops.jpeg_entropy_device import TorchJpegEncoder


def local_words_for_quality(quality: int) -> int:
    """Per-block word budget by quality, as the JAX package chooses it:
    blocks over budget are re-packed or coded on the host. Measured maxima
    on uniform noise: 330 bits at q85, 500 at q95, 782 at q100."""
    if quality <= 85:
        return 12
    if quality <= 95:
        return 16
    return 24


class TorchStreamingJpegEncoder(StreamingJpegEncoder):
    """Band-streaming JPEG encoder with quantize and entropy pack on a
    torch ``device``. Output bytes equal the JAX package's for the same
    options."""

    def __init__(self, width: int, height: int, quality: int = 85,
                 sampling: str = "444", restart_interval_rows: int = 0, *,
                 device, counters: EncodeCounters | None = None):
        super().__init__(
            width, height, quality, backend="torch", sampling=sampling,
            restart_interval_rows=restart_interval_rows,
        )
        self._dev_encoder = TorchJpegEncoder(
            self.luma_q, self.chroma_q,
            self._dc_luma, self._ac_luma, self._dc_chroma, self._ac_chroma,
            device=device,
            restart_interval_rows=self._restart_rows,
            sampling=sampling,
            local_words=local_words_for_quality(quality),
            counters=counters,
        )
