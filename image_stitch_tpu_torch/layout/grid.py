"""Grid layout planning.

Counterpart of the reference's grid planner (src/image-concat-core.ts:132-261).
Semantics frozen from the reference:
- ``columns`` fills row-major (idx = row*columns + col, :148-155).
- ``rows`` fills **column-major** (idx = col*rows + row, :156-164).
- Per-row heights and per-row per-column widths allow variable tile sizes
  (:177-203); empty cells are -1.
- ``width``/``height`` pixel limits wrap rows by cumulative width and stop
  adding rows that would exceed the height limit (:209-261).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from ..types import Layout, PngHeader


@dataclass(frozen=True)
class GridLayout:
    grid: list[list[int]]
    row_heights: list[int]
    col_widths: list[list[int]]
    total_width: int
    total_height: int


def calculate_pixel_based_layout(
    headers: Sequence[PngHeader],
    max_width: int | None,
    max_height: int | None,
    fixed_columns: int | None = None,
    fixed_rows: int | None = None,
) -> list[list[int]]:
    """(reference: calculatePixelBasedLayout, image-concat-core.ts:209-261)."""
    grid: list[list[int]] = []
    current_row: list[int] = []
    current_row_width = 0
    current_row_max_height = 0
    total_height = 0

    for i, header in enumerate(headers):
        w, h = header.width, header.height
        exceeds_width = bool(max_width) and (current_row_width + w > max_width)
        exceeds_cols = bool(fixed_columns) and (len(current_row) >= fixed_columns)

        if (exceeds_width or exceeds_cols) and current_row:
            exceeds_height = bool(max_height) and (
                total_height + current_row_max_height + h > max_height
            )
            if exceeds_height:
                break
            grid.append(current_row)
            total_height += current_row_max_height
            current_row = [i]
            current_row_width = w
            current_row_max_height = h
        else:
            current_row.append(i)
            current_row_width += w
            current_row_max_height = max(current_row_max_height, h)

        if fixed_rows and len(grid) >= fixed_rows and not current_row:
            break

    if current_row:
        grid.append(current_row)
    return grid


def calculate_layout(headers: Sequence[PngHeader], layout: Layout) -> GridLayout:
    """(reference: calculateLayout, image-concat-core.ts:132-206)."""
    n = len(headers)

    if layout.columns and not layout.height:
        columns = layout.columns
        rows = -(-n // columns)
        grid = [
            [
                (row * columns + col) if (row * columns + col) < n else -1
                for col in range(columns)
            ]
            for row in range(rows)
        ]
    elif layout.rows and not layout.width:
        rows = layout.rows
        columns = -(-n // rows)
        grid = [
            [
                (col * rows + row) if (col * rows + row) < n else -1
                for col in range(columns)
            ]
            for row in range(rows)
        ]
    elif layout.width or layout.height:
        grid = calculate_pixel_based_layout(
            headers, layout.width, layout.height, layout.columns, layout.rows
        )
    else:
        grid = [list(range(n))]

    row_heights: list[int] = []
    col_widths: list[list[int]] = []
    for row in grid:
        max_height = 0
        widths: list[int] = []
        for col, image_idx in enumerate(row):
            while len(widths) <= col:
                widths.append(0)
            if image_idx >= 0:
                header = headers[image_idx]
                max_height = max(max_height, header.height)
                widths[col] = max(widths[col], header.width)
        row_heights.append(max_height)
        col_widths.append(widths)

    total_height = sum(row_heights)
    total_width = max((sum(w) for w in col_widths), default=0)
    return GridLayout(grid, row_heights, col_widths, total_width, total_height)
