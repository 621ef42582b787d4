"""The program's own spans in the profiled jobs: the PNG encoder's host
side, its filter submits, deflate and IDAT framing (``png.submit``,
``png.deflate``, ``png.idat``), per band."""

from stitchbench.common.spans import ms_per_band


def read(trace):
    return ms_per_band(trace, {"png.submit", "png.deflate", "png.idat"})
