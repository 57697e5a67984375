"""BuffCut in PyTorch and CUDA: the port of the JAX package `repro`.

Host code (stream, buffer, scores, batch model, host V-cycle engines) is
numpy as in the reference; the device V-cycle (`core/multilevel_torch.py`)
and the neighbor-label histogram kernel run on a CUDA card.  The model
substrate so far is LM serving and DLRM serving (`configs/`, `models/`,
`launch/serve.py`), whose sliding-window decode attention and embedding
bag are CUDA kernels too.  `repro_torch.kernels` exports the reference's
four public kernel ops (`block_histogram`, `fennel_choose_batch`,
`embedding_bag`, `swa_attention_decode`), each a hand-written CUDA kernel
on the card.  Nothing here imports `jax` or `repro`.
"""
