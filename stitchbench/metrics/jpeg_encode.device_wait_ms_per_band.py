"""The program's own spans in the profiled jobs: the JPEG encoder's first
blocking read-back of a band, where the host waits on the card
(``jpeg.device_wait``), per band."""

from stitchbench.common.spans import ms_per_band


def read(trace):
    return ms_per_band(trace, {"jpeg.device_wait"})
