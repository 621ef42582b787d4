"""The program's own spans in the profiled jobs: the PNG tiles' inflate
(``decode.inflate``, ``NativeInflater.drain_into``), per band."""

from stitchbench.common.spans import ms_per_band


def read(trace):
    return ms_per_band(trace, {"decode.inflate"})
