"""100 less the union of device activity (kernels, copies, memsets) over the
wall of the profiled slice of whole jobs."""

from stitchbench.common.readers import idle_pct


def read(trace):
    return idle_pct(trace)
