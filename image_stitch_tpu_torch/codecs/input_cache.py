"""Opt-in shared-input scanline cache.

Counterpart of the reference's input cache in ``src/png-input-adapter.ts``
(:34-148): when the same byte buffer appears multiple times in one grid
(tiled mega-images), decode it once and serve all consumers from the cache.
The reference coordinates async producer/waiter generators
(consumeCachedScanlines :87); here a single producer decoder fills a shared
band list that any number of consumer decoders re-chunk at their own band
height. Off by default; enable via :func:`enable_input_cache`
(reference: enableInputCache :121, module-level toggle).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

_enabled = False
_entries: dict[int, "_CacheEntry"] = {}


def enable_input_cache() -> None:
    global _enabled
    _enabled = True


def disable_input_cache() -> None:
    """Disable and drop all cached data (reference: disableInputCache,
    png-input-adapter.ts:131-142)."""
    global _enabled
    _enabled = False
    _entries.clear()


def input_cache_enabled() -> bool:
    return _enabled


class _CacheEntry:
    """Holds the producing decoder and the bands decoded so far."""

    def __init__(self, source, make_decoder):
        import threading

        self.source = source  # strong ref: keeps id() stable while cached
        self._make_decoder = make_decoder
        self._decoder = None
        self._iter = None
        self.header = None
        self.bands: list[np.ndarray] = []
        self.done = False
        # host_threads workers can consume the same entry from different
        # RowSources; the produce-on-demand iterator is single-writer.
        self._lock = threading.Lock()

    def ensure_header(self):
        with self._lock:
            if self.header is None:
                self._decoder = self._make_decoder()
                self.header = self._decoder.get_header()
            return self.header

    def ensure_band(self, index: int) -> bool:
        """Make band ``index`` available; False if the stream ended first."""
        self.ensure_header()
        with self._lock:
            if self._iter is None:
                self._iter = self._decoder.bands(None)
            while len(self.bands) <= index and not self.done:
                try:
                    self.bands.append(next(self._iter))
                except StopIteration:
                    self.done = True
                    self._decoder.close()
            return index < len(self.bands)


class CachedDecoder:
    """Consumer view over a shared cache entry. Any number of these can read
    the same input concurrently at independent positions."""

    def __init__(self, entry: _CacheEntry):
        self._entry = entry

    @property
    def format(self) -> str:
        return getattr(self._entry._decoder, "format", "png") if self._entry._decoder else "png"

    def get_header(self):
        return self._entry.ensure_header()

    def bands(self, band_height: int | None = None) -> Iterator[np.ndarray]:
        buf: np.ndarray | None = None
        i = 0
        while True:
            if band_height is None:
                if not self._entry.ensure_band(i):
                    break
                yield self._entry.bands[i]
                i += 1
                continue
            while (buf is None or buf.shape[0] < band_height) and self._entry.ensure_band(i):
                nxt = self._entry.bands[i]
                i += 1
                buf = nxt if buf is None else np.vstack([buf, nxt])
            if buf is None or buf.shape[0] == 0:
                break
            yield buf[:band_height]
            buf = buf[band_height:] if buf.shape[0] > band_height else None

    def scanlines(self) -> Iterator[np.ndarray]:
        for band in self.bands(None):
            for row in band:
                yield row

    def device_band_decoder(self, device):
        """Pass the device band tier through the cache view: decode_band
        is stateless random access, so consumers at independent positions
        can share one underlying DeviceJpegDecoder."""
        self._entry.ensure_header()
        get = getattr(self._entry._decoder, "device_band_decoder", None)
        return get(device) if get is not None else None

    def close(self) -> None:
        pass  # shared entry lifecycle is owned by the cache


def cached_decoder_for(source, make_decoder) -> CachedDecoder | None:
    """Return a cache-backed decoder for a bytes-like source, or None when
    the cache is disabled or the source isn't cacheable."""
    if not _enabled:
        return None
    if not isinstance(source, (bytes, bytearray, memoryview, np.ndarray)):
        return None
    key = id(source)
    entry = _entries.get(key)
    if entry is None or entry.source is not source:
        entry = _CacheEntry(source, make_decoder)
        _entries[key] = entry
    return CachedDecoder(entry)
