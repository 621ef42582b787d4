"""Shared inputs of the torch port's tests (tests/test_torch_*.py)."""

from __future__ import annotations

import numpy as np

from image_stitch_tpu.codecs.jpeg.tables import (
    STD_AC_CHROMA_BITS,
    STD_AC_CHROMA_VALS,
    STD_AC_LUMA_BITS,
    STD_AC_LUMA_VALS,
    STD_DC_CHROMA_BITS,
    STD_DC_CHROMA_VALS,
    STD_DC_LUMA_BITS,
    STD_DC_LUMA_VALS,
    build_huffman_codes,
)

# The standard Huffman tables as (dc_luma, ac_luma, dc_chroma, ac_chroma).
TABLES = (
    build_huffman_codes(STD_DC_LUMA_BITS, STD_DC_LUMA_VALS),
    build_huffman_codes(STD_AC_LUMA_BITS, STD_AC_LUMA_VALS),
    build_huffman_codes(STD_DC_CHROMA_BITS, STD_DC_CHROMA_VALS),
    build_huffman_codes(STD_AC_CHROMA_BITS, STD_AC_CHROMA_VALS),
)


def u32(x) -> np.ndarray:
    """int32 bit patterns (a torch tensor or an array) -> uint32 numpy."""
    if hasattr(x, "numpy"):
        x = x.numpy()
    return np.asarray(x).astype(np.int64).astype(np.uint32)
