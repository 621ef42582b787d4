"""The program's own spans in the profiled jobs: the JPEG encoder's host
side, its submits and waits (``jpeg.submit``, ``jpeg.wait``) less the time
the waits block on the card (``jpeg.device_wait``), per band."""

from stitchbench.common.spans import ms_per_band


def read(trace):
    return ms_per_band(trace, {"jpeg.submit", "jpeg.wait"}, less={"jpeg.device_wait"})
