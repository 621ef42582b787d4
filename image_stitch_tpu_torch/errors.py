"""Error types for the stitching pipeline.

Mirrors the diagnostic style of the reference's ``createStitchError``
(reference: src/image-concat-core.ts:21-28): rich, actionable messages that
name the input index, row/column, and expected-vs-actual dimensions.
"""

from __future__ import annotations


class StitchError(Exception):
    """Raised for invalid inputs, layout mismatches, and decode failures."""

    def __init__(self, message: str, cause: Exception | None = None):
        if cause is not None:
            message = f"{message}: {cause}"
        super().__init__(message)
        self.cause = cause


def format_pixels(value: float) -> str:
    """Format a pixel count for diagnostics (reference: image-concat-core.ts:30-36)."""
    if value == int(value):
        return f"{int(value)}px"
    return f"{value:.2f}px"
