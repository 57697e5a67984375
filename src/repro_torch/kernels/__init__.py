"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

Kernel libraries are built with nvcc at first use (`_build.py`); importing
this package builds nothing.
"""
