"""Over the traced run's layer pairs, a whole job's wall per band less its
paired decode-and-layout pass's: what the PNG encoder (filter on the card,
deflate on the host) adds."""

from stitchbench.common.readers import added_ms_per_band


def read(trace):
    return added_ms_per_band(trace, "png")
