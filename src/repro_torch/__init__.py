"""BuffCut in PyTorch and CUDA: the port of the JAX package `repro`.

Host code (stream, buffer, scores, batch model, host V-cycle engines) is
numpy as in the reference; the device V-cycle (`core/multilevel_torch.py`)
and the neighbor-label histogram kernel (`kernels/`) run on a CUDA card.
The model substrate so far is LM serving (`configs/`, `models/`,
`launch/serve.py`), whose sliding-window decode attention is a CUDA
kernel too.  Nothing here imports `jax` or `repro`.
"""
