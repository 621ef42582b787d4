"""torch.cuda.max_memory_allocated() over the window, reset at its start."""


def read(trace):
    return trace.device_peak_bytes / 1e6 if trace.device_peak_bytes else None
