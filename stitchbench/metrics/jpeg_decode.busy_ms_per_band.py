"""The program's own spans in the profiled jobs: the JPEG-tile device
decode's host side, each tile opened (``decode.jpeg.open``: the host
Huffman decode and the zigzag-prefix extraction) and each band decoded
(``decode.jpeg.band``: staging, upload and launches), per band."""

from stitchbench.common.spans import ms_per_band


def read(trace):
    return ms_per_band(trace, {"decode.jpeg.open", "decode.jpeg.band"})
