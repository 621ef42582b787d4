"""The program's own spans in the profiled jobs: a band of JPEG tiles
staged (``decode.jpeg.stage``: the kernels' tables, the copies into the
pinned slot of the decode's ring, the queued upload), per band."""

from stitchbench.common.spans import ms_per_band


def read(trace):
    return ms_per_band(trace, {"decode.jpeg.stage"})
