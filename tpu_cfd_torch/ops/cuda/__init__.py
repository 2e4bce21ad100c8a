"""Hand-written CUDA kernels for Hopper, bound with ctypes."""
