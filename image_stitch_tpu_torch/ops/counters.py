"""What a run did, on the device or the host tier, counted by the modules
that do it."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class EncodeCounters:
    """What a run did on the device, and on the host tier.

    JPEG (``TorchJpegEncoder``): bands submitted, on-device re-packs after
    an overflow, and bands coded on the host because they overflowed every
    device budget; host bands uploaded through its staging ring
    (``ops.staging.BandStaging``), and the acquires of a ring slot whose
    earlier copy was still in flight (the host waited for it). PNG
    (``ops.device.TorchBackend``): bands filtered.
    Positioned compositing (``ops.composite_device.DeviceCompositor``):
    bands blended on the device, and bands replayed through the host oracle
    on an exact rational tie. JPEG tiles decoded by the device tier
    (``codecs.jpeg.device_decoder.DeviceTileBands``): decodes counted per
    tile and band, the bands decoded whole into a band tensor on the device
    (one upload and two launches for each row of tiles a band crosses,
    whatever the number of tiles), the tiles the tier opened (each one host Huffman decode),
    those of them whose upload came straight from the native scan's zigzag
    store (``DeviceJpegDecoder.native_prefix``), and, read from the tier's
    staging ring at the end of a run, its uploads and the acquires of a slot
    whose earlier copy was still in flight.
    Bands encoded by the host tier (``backend="numpy"``: the host
    ``StreamingJpegEncoder``, and ``core._encode_png`` on
    ``ops.backend.NumpyBackend``), which launches no kernel. Under a mesh (``parallel.mesh``): the JPEG dispatches made on
    its shards (each one quantize, symbols, layout and pack; a band's tail
    group included), and the slabs that ``TorchBackend`` filtered or
    quantized on them. The PNG writer's owned deflate
    (``native.NativeDeflator``, on either tier): its sync-flush batches,
    and those of them compressed on a worker (the concatenator's deflate
    worker at ``host_threads`` 1, its pool above) while the caller went on
    with the next band."""

    bands: int = 0
    repacks: int = 0
    host_fallback_bands: int = 0
    staged_uploads: int = 0
    staging_stalls: int = 0
    png_bands: int = 0
    composite_bands_on_device: int = 0
    composite_fallback_bands: int = 0
    decode_tile_bands: int = 0
    decode_bands_on_device: int = 0
    decode_tiles_opened: int = 0
    decode_tiles_native_prefix: int = 0
    decode_staged_uploads: int = 0
    decode_staging_stalls: int = 0
    host_tier_bands: int = 0
    mesh_dispatches: int = 0
    mesh_slabs: int = 0
    deflate_batches: int = 0
    deflate_batches_overlapped: int = 0
