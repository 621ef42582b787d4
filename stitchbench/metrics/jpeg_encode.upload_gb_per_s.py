"""The program's own spans in the profiled jobs: the bytes the JPEG
encoder stages onto the card (``jpeg.upload``'s ``n``: the RGB copy, pinned
and queued) over the time its uploads take on the host, in GB/s."""

from stitchbench.common.spans import gb_per_s


def read(trace):
    return gb_per_s(trace, "jpeg.upload")
