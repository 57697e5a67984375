"""BuffCut in PyTorch and CUDA: the port of the JAX package `repro`.

The front door is `repro_torch.api.partition` (CLI: `python -m
repro_torch`), over the three BuffCut drivers and the HeiStream, Cuttana,
Fennel and LDG baselines.  Host code (stream, buffer, scores, batch
model, host V-cycle engines, the baselines but HeiStream's V-cycle) is
numpy as in the reference; the device V-cycle (`core/multilevel_torch.py`)
and the neighbor-label histogram kernel run on a CUDA card.  The model
substrate so far is LM serving and DLRM serving (`configs/`, `models/`,
`launch/serve.py`), whose sliding-window decode attention and embedding
bag are CUDA kernels too, and GNN training: BuffCut as the placement
service (`distributed/gnn_placement.py`), the fanout sampler
(`graphs/sampler.py`), the four GNN models (`models/gnn.py`) and the
training substrate (`train/`, `launch/train.py`).  `repro_torch.kernels` exports the reference's
four public kernel ops (`block_histogram`, `fennel_choose_batch`,
`embedding_bag`, `swa_attention_decode`), each a hand-written CUDA kernel
on the card.  `repro_torch.analysis` is the reference's invariant linter,
applied to the port (`python -m repro_torch analyze`).  Nothing here
imports `jax` or `repro`, and the partitioning path (the API and CLI,
`core/`, `graphs/`, the shard driver, `serve/`, `launch/serve.py`)
imports torch only where it runs on a card, so importing it loads none.
"""
