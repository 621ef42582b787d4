"""All canvas megapixels of the window's jobs over the window's seconds (the
window closes with the last job's last chunk)."""


def read(trace):
    if not trace.jobs or trace.window_s <= 0:
        return None
    done = [r for r in trace.jobs if r.error is None]
    return sum(r.megapixels for r in done) / trace.window_s
