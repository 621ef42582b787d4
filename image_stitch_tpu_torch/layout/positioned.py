"""Positioned (free-form) layout planning.

Counterpart of the reference's ``src/positioned-layout.ts``. Semantics frozen:
- Auto canvas size = max(x+w), max(y+h), each floored at 1
  (positioned-layout.ts:80-104).
- Clipping records clipped rects, ``source_offset_x/y`` for negative
  coordinates, a ``fully_clipped`` flag, and warns via a logger (:107-199).
- Default z_index = input index; ties broken by input index (:184, :228-234).

TPU-first redesign: instead of a per-scanline Map (buildScanlineIndex,
:201-242) the planner exposes *band plans* — for a band of output rows, the
z-sorted list of images intersecting the band with their row ranges — so a
whole band composites in one fused device pass. The per-row index is kept for
API parity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

from ..types import PngHeader


@dataclass
class PositionedImageInfo:
    """(reference: PositionedImageInfo, positioned-layout.ts:13-29)."""

    image_idx: int
    x: int
    y: int
    z_index: int
    width: int
    height: int
    current_scanline: int = 0


@dataclass(frozen=True)
class ScanlineIntersection:
    """(reference: ScanlineIntersection, positioned-layout.ts:31-44)."""

    image_idx: int
    local_y: int
    start_x: int
    end_x: int
    z_index: int


@dataclass(frozen=True)
class ClippedImageInfo:
    """(reference: ClippedImageInfo, positioned-layout.ts:46-68)."""

    image_idx: int
    original_x: int
    original_y: int
    original_width: int
    original_height: int
    clipped_x: int
    clipped_y: int
    clipped_width: int
    clipped_height: int
    source_offset_x: int
    source_offset_y: int
    fully_clipped: bool


def calculate_canvas_size(
    positioned_images: Sequence[dict],
    explicit_width: int | None = None,
    explicit_height: int | None = None,
) -> tuple[int, int]:
    """(reference: calculateCanvasSize, positioned-layout.ts:80-104)."""
    if explicit_width is not None and explicit_height is not None:
        return explicit_width, explicit_height
    max_right = 0
    max_bottom = 0
    for img in positioned_images:
        max_right = max(max_right, img["x"] + img["width"])
        max_bottom = max(max_bottom, img["y"] + img["height"])
    width = explicit_width if explicit_width is not None else max(1, max_right)
    height = explicit_height if explicit_height is not None else max(1, max_bottom)
    return width, height


def clip_images_to_canvas(
    positions: Sequence[dict],
    headers: Sequence[PngHeader],
    canvas_width: int,
    canvas_height: int,
    logger: Callable[[str], None] | None = None,
) -> tuple[list[ClippedImageInfo], list[PositionedImageInfo]]:
    """(reference: clipImagesToCanvas, positioned-layout.ts:107-199)."""
    import warnings

    log = logger or (lambda msg: warnings.warn(msg, stacklevel=3))
    clipped_images: list[ClippedImageInfo] = []
    positioned_images: list[PositionedImageInfo] = []

    for i, pos in enumerate(positions):
        x, y = pos["x"], pos["y"]
        header = headers[i]
        width, height = header.width, header.height

        left = max(0, x)
        top = max(0, y)
        right = min(canvas_width, x + width)
        bottom = min(canvas_height, y + height)

        is_clipped = x < 0 or y < 0 or x + width > canvas_width or y + height > canvas_height
        fully_clipped = right <= left or bottom <= top

        if is_clipped:
            clipped_images.append(
                ClippedImageInfo(
                    image_idx=i,
                    original_x=x,
                    original_y=y,
                    original_width=width,
                    original_height=height,
                    clipped_x=left,
                    clipped_y=top,
                    clipped_width=0 if fully_clipped else right - left,
                    clipped_height=0 if fully_clipped else bottom - top,
                    source_offset_x=max(0, -x),
                    source_offset_y=max(0, -y),
                    fully_clipped=fully_clipped,
                )
            )
            if fully_clipped:
                log(
                    f"Image #{i + 1} is completely outside canvas bounds: "
                    f"position=({x}, {y}), size=({width}×{height}), "
                    f"canvas=({canvas_width}×{canvas_height}). Image will not be rendered."
                )
            else:
                parts = []
                if x < 0:
                    parts.append(f"left by {-x}px")
                if y < 0:
                    parts.append(f"top by {-y}px")
                if x + width > canvas_width:
                    parts.append(f"right by {x + width - canvas_width}px")
                if y + height > canvas_height:
                    parts.append(f"bottom by {y + height - canvas_height}px")
                log(
                    f"Image #{i + 1} clipped ({', '.join(parts)}): "
                    f"original=({x}, {y}, {width}×{height}), "
                    f"visible=({left}, {top}, {right - left}×{bottom - top}), "
                    f"canvas=({canvas_width}×{canvas_height})"
                )

        if not fully_clipped:
            z = pos.get("z_index")
            positioned_images.append(
                PositionedImageInfo(
                    image_idx=i,
                    x=left,
                    y=top,
                    width=right - left,
                    height=bottom - top,
                    z_index=z if z is not None else i,
                )
            )

    return clipped_images, positioned_images


def build_scanline_index(
    positioned_images: Sequence[PositionedImageInfo], canvas_height: int
) -> dict[int, list[ScanlineIntersection]]:
    """Per-row z-sorted work list (reference: buildScanlineIndex,
    positioned-layout.ts:201-242). Kept for API parity; the band engine uses
    :func:`build_band_plan`."""
    index: dict[int, list[ScanlineIntersection]] = {}
    for output_y in range(canvas_height):
        intersections = [
            ScanlineIntersection(
                image_idx=img.image_idx,
                local_y=output_y - img.y,
                start_x=img.x,
                end_x=img.x + img.width,
                z_index=img.z_index,
            )
            for img in positioned_images
            if img.y <= output_y < img.y + img.height
        ]
        intersections.sort(key=lambda it: (it.z_index, it.image_idx))
        if intersections:
            index[output_y] = intersections
    return index


@dataclass(frozen=True)
class BandIntersection:
    """One image's overlap with a band of output rows (TPU-native plan unit)."""

    image_idx: int
    # Rows of the *visible* (clipped) image covered by this band.
    local_y0: int
    local_y1: int  # exclusive
    # Where those rows land inside the band.
    band_y0: int
    start_x: int
    end_x: int
    z_index: int


def build_band_plan(
    positioned_images: Sequence[PositionedImageInfo],
    canvas_height: int,
    band_height: int,
) -> list[list[BandIntersection]]:
    """Plan every output band: z-sorted image segments per band.

    Band b covers output rows [b*band_height, min((b+1)*band_height, H)).
    Within a band, segments are sorted by (z_index, image_idx) — the same
    back-to-front order the reference applies per scanline.
    """
    plans: list[list[BandIntersection]] = []
    for band_start in range(0, canvas_height, band_height):
        band_end = min(band_start + band_height, canvas_height)
        segs = []
        for img in positioned_images:
            y0 = max(band_start, img.y)
            y1 = min(band_end, img.y + img.height)
            if y1 <= y0:
                continue
            segs.append(
                BandIntersection(
                    image_idx=img.image_idx,
                    local_y0=y0 - img.y,
                    local_y1=y1 - img.y,
                    band_y0=y0 - band_start,
                    start_x=img.x,
                    end_x=img.x + img.width,
                    z_index=img.z_index,
                )
            )
        segs.sort(key=lambda s: (s.z_index, s.image_idx))
        plans.append(segs)
    return plans


def get_effective_positioned_images(
    positions: Sequence[dict],
    headers: Sequence[PngHeader],
    canvas_width: int,
    canvas_height: int,
    logger: Callable[[str], None] | None = None,
):
    """(reference: getEffectivePositionedImages, positioned-layout.ts:244-259)."""
    clipped, positioned = clip_images_to_canvas(
        positions, headers, canvas_width, canvas_height, logger
    )
    return positioned, clipped
