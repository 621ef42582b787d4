"""Arithmetic that several metric readers share."""

import statistics


def ms_per_band(seconds: float, bands: int) -> float:
    return seconds / bands * 1e3


def added_ms_per_band(trace, fmt: str):
    """Over the traced run's layer pairs, the mean of (a whole job's wall a
    band less the paired decode-and-layout pass's), for a cell whose output
    is ``fmt``."""
    if trace.cell.options["outputFormat"] != fmt or not trace.layer_pairs:
        return None
    diffs = [ms_per_band(p["whole_s"], p["whole_bands"]) - ms_per_band(p["decode_s"],
                                                                       p["decode_bands"])
             for p in trace.layer_pairs if p["whole_bands"] and p["decode_bands"]]
    return statistics.fmean(diffs) if diffs else None


def idle_pct(trace):
    p = trace.profile
    if not p or p["wall_s"] <= 0 or p["activities"] == 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["wall_s"])
