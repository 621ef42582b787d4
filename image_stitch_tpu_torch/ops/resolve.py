"""The port's one device normaliser, ``resolve_device``.

A leaf module, importing only torch and the port's errors, so that every
holder of a device (the mesh, the staging ring, the decoders, the encoders,
the backends) can take its devices from here.
"""

from __future__ import annotations

import torch

from ..errors import StitchError


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a torch.device, a card always with its index: "cuda"
    is the current card. Every device the port holds comes from here, so
    two devices compare equal exactly when they are the same. "cuda"
    without a usable card raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise StitchError(
            f"device={str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain torch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise StitchError(f"Unsupported device: {device}")
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev
