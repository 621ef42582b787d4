"""Device ops of the torch port: quantize, entropy symbols and the hand-written kernels."""
