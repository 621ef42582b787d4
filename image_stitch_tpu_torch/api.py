"""Public entry points of the torch port, the counterparts of
``image_stitch_tpu.api``'s ``concat_to_buffer``, ``concat_streaming`` and
``concat_to_file``.

Each takes the same options (a ``ConcatOptions`` or a dict, snake_case or
camelCase keys) plus a keyword ``device``: "cuda" (the default) runs the
band work (JPEG or PNG encode, positioned compositing) on the GPU and
raises when CUDA is absent; "cpu" runs the plain torch versions of the
kernels. ``counters``, when given, receives what the device did (JPEG
bands, re-packs and host-coded bands; PNG bands; composited and replayed
positioned bands).
"""

from __future__ import annotations

import os
from typing import Any, Iterator, Mapping

from .types import ConcatOptions

from .core import TorchStreamingConcatenator
from .ops.counters import EncodeCounters

Options = ConcatOptions | Mapping[str, Any]


def concat_streaming(options: Options, *, device="cuda",
                     counters: EncodeCounters | None = None) -> Iterator[bytes]:
    """Generator of encoded output chunks."""
    return TorchStreamingConcatenator(options, device=device, counters=counters).stream()


def concat_to_buffer(options: Options, *, device="cuda",
                     counters: EncodeCounters | None = None) -> bytes:
    """Concatenate and return the whole encoded file."""
    return b"".join(concat_streaming(options, device=device, counters=counters))


def concat_to_file(options: Options, path: str | os.PathLike, *, device="cuda",
                   counters: EncodeCounters | None = None) -> None:
    """Stream the encoded output into a file."""
    with open(path, "wb") as f:
        for chunk in concat_streaming(options, device=device, counters=counters):
            f.write(chunk)
