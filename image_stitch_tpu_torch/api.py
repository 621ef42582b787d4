"""Public entry points of the torch port, the counterparts of
``image_stitch_tpu.api``: ``concat_to_buffer``, ``concat_streaming``,
``concat_to_file``, ``concat_to_stream`` with its ``StreamingConcatenator``,
the deprecated ``concat`` and the array-native ``concat_arrays``.

Each takes the same options (a ``ConcatOptions`` or a dict, snake_case or
camelCase keys) plus a keyword ``device``: "cuda" (the default) runs the
band work (JPEG or PNG encode, positioned compositing) on the GPU and
raises when CUDA is absent; "cpu" runs the plain torch versions of the
kernels. The option ``backend="numpy"`` (or "oracle") runs the host tier
instead and leaves ``device`` unread; ``backend="auto"`` lets the JAX
package's policy choose from the canvas's size and the link to ``device``
(ops/backend.py). ``counters``, when given, receives
what the device did (JPEG bands, re-packs and host-coded bands; PNG bands;
composited and replayed positioned bands) and the bands the host tier
encoded.
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Iterator, Mapping

import numpy as np

from .types import ConcatOptions

from .core import TorchStreamingConcatenator, stream_once
from .ops.counters import EncodeCounters

Options = ConcatOptions | Mapping[str, Any]


class StreamingConcatenator:
    """Streaming facade over ``TorchStreamingConcatenator``: iterate it, or
    write it to a file-like object."""

    def __init__(self, options: Options, *, device="cuda",
                 counters: EncodeCounters | None = None):
        self._core = TorchStreamingConcatenator(options, device=device, counters=counters)

    def __iter__(self) -> Iterator[bytes]:
        return self._core.stream()

    def stream(self) -> Iterator[bytes]:
        return self._core.stream()

    def to_stream(self, writable) -> None:
        """Write all chunks to a file-like object, as they are made."""
        for chunk in self._core.stream():
            writable.write(chunk)


def concat_streaming(options: Options, *, device="cuda",
                     counters: EncodeCounters | None = None) -> Iterator[bytes]:
    """Generator of encoded output chunks."""
    return stream_once(TorchStreamingConcatenator(options, device=device, counters=counters))


def concat_to_buffer(options: Options, *, device="cuda",
                     counters: EncodeCounters | None = None) -> bytes:
    """Concatenate and return the whole encoded file."""
    return b"".join(concat_streaming(options, device=device, counters=counters))


def concat_to_file(options: Options, path: str | os.PathLike, *, device="cuda",
                   counters: EncodeCounters | None = None) -> None:
    """Stream the encoded output into a file. Options and device are checked
    before the file is opened, so a refused call leaves no empty file."""
    chunks = concat_streaming(options, device=device, counters=counters)
    with open(path, "wb") as f:
        for chunk in chunks:
            f.write(chunk)


def concat_to_stream(options: Options, *, device="cuda",
                     counters: EncodeCounters | None = None) -> StreamingConcatenator:
    """A lazy iterator of encoded chunks (Python's iterator protocol is the
    pull-driven stream)."""
    return StreamingConcatenator(options, device=device, counters=counters)


def concat(options: Options, *, device="cuda",
           counters: EncodeCounters | None = None) -> bytes:
    """Deprecated alias of ``concat_to_buffer``."""
    warnings.warn(
        "concat() is deprecated; use concat_to_buffer()",
        DeprecationWarning,
        stacklevel=2,
    )
    return concat_to_buffer(options, device=device, counters=counters)


def concat_arrays(arrays: list[np.ndarray], layout: Mapping[str, int] | None = None,
                  output: str = "array", *, device="cuda",
                  counters: EncodeCounters | None = None, **kwargs):
    """Stitch (H, W, 3|4) uint8 arrays. ``output``: "array" assembles the
    (H, W, 4) result from the compositing pipeline's bands, with no encode
    and decode between; "png" and "jpeg" return encoded bytes. Further
    keywords are options. ``device`` is not one of them: it is the port's
    own keyword."""
    opts: dict[str, Any] = {"inputs": list(arrays), "layout": dict(layout or {})}
    if output == "jpeg":
        opts["output_format"] = "jpeg"
    opts.update(kwargs)
    if output in ("png", "jpeg"):
        return concat_to_buffer(opts, device=device, counters=counters)
    core = TorchStreamingConcatenator(opts, device=device, counters=counters)
    return np.vstack(list(core.stream_bands()))
