"""The program's own spans in the profiled jobs: the PNG encoder's waits
on the card for a band's filtered rows (``png.device_wait``), per band."""

from stitchbench.common.spans import ms_per_band


def read(trace):
    return ms_per_band(trace, {"png.device_wait"})
