"""The program's own spans in the profiled jobs: host deflate of the
filtered rows (``png.deflate``, ``StreamingDeflator.push`` and
``finish``), per band."""

from stitchbench.common.spans import ms_per_band


def read(trace):
    return ms_per_band(trace, {"png.deflate"})
