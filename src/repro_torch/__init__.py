"""BuffCut in PyTorch and CUDA: the port of the JAX package `repro`.

Host code (stream, buffer, scores, batch model, host V-cycle engines) is
numpy as in the reference; the device V-cycle (`core/multilevel_torch.py`)
and the neighbor-label histogram kernel (`kernels/`) run on a CUDA card.
Nothing here imports `jax` or `repro`.
"""
