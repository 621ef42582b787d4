"""The process's highest resident set over the window, sampled every 5 ms."""


def read(trace):
    return trace.rss_peak_bytes / 1e6
