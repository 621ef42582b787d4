"""The program's own spans in the profiled jobs: host band assembly
(``assemble``, the tile pulls under it) and any tile pull outside it (a
top-level ``decode.png``), per band."""

from stitchbench.common.spans import ms_per_band


def read(trace):
    return ms_per_band(trace, {"assemble"}, top={"decode.png"})
