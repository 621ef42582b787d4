"""Seconds from the start of the process to the end of the warm-up jobs:
torch and the CUDA context, the kernels (built on a checkout's first run),
the inputs, the warm-up."""


def read(trace):
    return trace.setup_s
