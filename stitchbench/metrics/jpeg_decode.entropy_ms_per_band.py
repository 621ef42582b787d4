"""The program's own spans in the profiled jobs: the host Huffman decode of
the JPEG tiles (``decode.jpeg.entropy``, once a tile a job), per band."""

from stitchbench.common.spans import ms_per_band


def read(trace):
    return ms_per_band(trace, {"decode.jpeg.entropy"})
