"""Hand-written CUDA kernels (csrc/) and their ctypes bindings."""
