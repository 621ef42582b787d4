"""Decoder plugin registry.

Counterpart of the reference's ``src/decoders/plugin-registry.ts``: a
module-global default plugin list with set/get/clear, falling back to
PNG-only when unset (plugin-registry.ts:6-25). The root package registers
PNG+JPEG+HEIC as defaults (reference src/index.ts:38-43).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Sequence


@dataclass(frozen=True)
class DecoderPlugin:
    """Format plugin (reference: DecoderPlugin, src/decoders/types.ts:165-173)."""

    format: str
    create: Callable[..., Any]  # (source, options) -> decoder


_default_plugins: list[DecoderPlugin] | None = None


def set_default_decoder_plugins(plugins: Sequence[DecoderPlugin]) -> None:
    global _default_plugins
    _default_plugins = list(plugins)


def get_default_decoder_plugins() -> list[DecoderPlugin]:
    if _default_plugins is None:
        from .png.decoder import png_plugin

        return [png_plugin()]
    return list(_default_plugins)


def clear_default_decoder_plugins() -> None:
    global _default_plugins
    _default_plugins = None
