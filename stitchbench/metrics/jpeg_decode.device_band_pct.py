"""The program's counters over the window: the share of the window's bands
that the JPEG-tile decode made whole on the card
(``decode_bands_on_device``), in percent. A band that falls to the host
tier gives the same bytes, so the check cannot see it; this share can."""


def read(trace):
    on_device = trace.counters.get("decode_bands_on_device")
    bands = sum(r.bands for r in trace.jobs)
    if on_device is None or not bands:
        return None
    return 100.0 * on_device / bands
