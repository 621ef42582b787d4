"""The JPEG-tile decode's two kernels (``idct_dequant``, ``ycc_rgba``) in
the profiled slice: the bytes its jobs' decode must move
(``common/decode_work.py``: the tiles' coefficients in, the canvas's RGBA
out) over 3.35 TB/s, over the kernels' summed device time, in percent of
the published peak. None where either kernel is not among the slice's
top device operations."""

from stitchbench.common.decode_work import decode_bytes, kernel_seconds
from stitchbench.common.work import HBM_BYTES_PER_S


def read(trace):
    p = trace.profile
    if not p:
        return None
    seconds = kernel_seconds(p.get("device_ops") or ())
    jobs = [j for j in p.get("jobs") or () if j.error is None]
    if not seconds or not jobs:
        return None
    return sum(decode_bytes(j.spec) for j in jobs) / HBM_BYTES_PER_S / seconds * 100
