"""Gradient compression (counterpart of `repro/distributed/compression.py`).

1. Top-k sparsification with error feedback [Lin et al., Deep Gradient
   Compression]: keep the k largest-magnitude entries per leaf, accumulate
   the residual locally and add it back next step (unbiased in the limit).
2. Int8 linear quantization with a per-leaf scale: 4x volume reduction
   for one extra max-reduce.

`quantized_psum` is the int8 all-reduce over a mesh axis: functional
collectives on the axis's process group.  Trees are nested dicts,
lists and tuples of tensors, walked in the reference's order (dict keys
sorted).  `torch.topk` may break ties between equal magnitudes otherwise
than `jax.lax.top_k`.
"""
from __future__ import annotations

import math

import torch  # repro: noqa RPR001 -- torch-resident module behind PEP-562-lazy distributed/__init__
import torch.distributed as dist  # repro: noqa RPR001 -- torch-resident module

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like


def topk_compress(g: torch.Tensor, ratio: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (values, flat_indices int32). k = max(1, ratio * size)."""
    flat = g.reshape(-1)
    k = max(1, int(flat.shape[0] * ratio))
    idx = torch.topk(flat.abs(), k).indices
    return flat[idx], idx.to(torch.int32)


def topk_decompress(vals: torch.Tensor, idx: torch.Tensor, shape) -> torch.Tensor:
    flat = torch.zeros(math.prod(shape), dtype=vals.dtype, device=vals.device)
    flat[idx.long()] = vals
    return flat.reshape(shape)


def error_feedback_update(g: torch.Tensor, residual: torch.Tensor, ratio: float):
    """One error-feedback step: compress (g + residual), return the
    transmitted dense equivalent and the new residual."""
    corrected = g + residual
    vals, idx = topk_compress(corrected, ratio)
    sent = topk_decompress(vals, idx, corrected.shape)
    return sent, corrected - sent


def compress_grads_with_feedback(grads, residuals, ratio: float):
    """Tree version; returns (sent_grads, new_residuals)."""
    sent, new_r = [], []
    for g, r in zip(tree_leaves(grads), tree_leaves(residuals)):
        s, nr = error_feedback_update(g, r, ratio)
        sent.append(s)
        new_r.append(nr)
    return tree_unflatten_like(grads, sent), tree_unflatten_like(grads, new_r)


def init_residuals(grads):
    return tree_map(torch.zeros_like, grads)


# ------------------------------------------------------------ int8 quant

def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def quantized_psum(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """All-reduce over `group` with int8 on the wire: quantize locally,
    all-gather the int8 payload and the scales, dequantize-sum locally
    (rounding half to even, as `jnp.round`).  The sum runs over ranks in
    group order as one float32 contraction, the reference's `tensordot`."""
    from repro_torch.distributed.spmd import all_gather

    q, scale = quantize_int8(x)
    n = dist.get_world_size(group)
    qs = all_gather(q.reshape(1, -1), 0, group)            # (P, size) int8
    ss = all_gather(scale.reshape(1), 0, group)            # (P,)
    out = torch.tensordot(ss, qs.to(torch.float32), dims=([0], [0]))
    return out.reshape(x.shape)
