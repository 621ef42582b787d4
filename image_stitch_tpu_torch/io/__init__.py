"""Host-side streaming compression (the L1 layer).

The reference uses the runtime's native ``CompressionStream`` /
``DecompressionStream`` (C zlib) with a pako fallback
(reference: src/streaming-inflate.ts:23-76, src/streaming-deflate.ts:41-242).
Here we call the same C zlib directly through Python's ``zlib`` module; this
stays on the TPU-VM host and overlaps with device compute via band
double-buffering in the orchestrator.
"""

from .inflate import StreamingInflator
from .deflate import StreamingDeflator, compress_streaming

__all__ = ["StreamingInflator", "StreamingDeflator", "compress_streaming"]
