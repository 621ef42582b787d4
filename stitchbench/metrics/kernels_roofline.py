"""Bytes the slice's device work must move (common/work.py: each input read
once, each output written once), over 3.35 TB/s, over the summed kernel
time of the slice, in percent of the published peak."""

from stitchbench.common.work import HBM_BYTES_PER_S


def read(trace):
    p = trace.profile
    if not p or p["kernel_s"] <= 0:
        return None
    return p["device_bytes"] / HBM_BYTES_PER_S / p["kernel_s"] * 100
