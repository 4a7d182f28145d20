"""Build and ctypes bindings of the CUDA kernels in ``csrc/``."""
