"""Build and binding of the hand-written CUDA kernels in ``csrc/``."""
