"""Shared model building blocks (counterpart of `repro/models/common.py`).

Weights keep the reference's `(fan_in, fan_out)` layout and apply as
`x @ w + b`, so carrying the reference's weights across is a copy.
"""
from __future__ import annotations

import math
from collections.abc import Callable

import torch


def dense_init(gen: torch.Generator, fan_in: int, fan_out: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(fan_in, fan_out) weights uniform in ±1/sqrt(fan_in), drawn from
    `gen` on its device (the reference's law; JAX's bits are not
    reproduced)."""
    scale = 1.0 / math.sqrt(fan_in)
    w = torch.rand((fan_in, fan_out), generator=gen, dtype=torch.float32, device=gen.device)
    return (w * (2 * scale) - scale).to(dtype)


def mlp_init(gen: torch.Generator, sizes: list[int], dtype: torch.dtype = torch.float32) -> dict:
    """{"w{i}": (sizes[i], sizes[i+1]), "b{i}": zeros (sizes[i+1],)}."""
    n = len(sizes) - 1
    params = {f"w{i}": dense_init(gen, sizes[i], sizes[i + 1], dtype) for i in range(n)}
    return params | {f"b{i}": torch.zeros((sizes[i + 1],), dtype=dtype, device=gen.device)
                     for i in range(n)}


def mlp_apply(params: dict, x: torch.Tensor,
              act: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
              final_act: Callable[[torch.Tensor], torch.Tensor] | None = None) -> torch.Tensor:
    """`x @ w{i} + b{i}` for each layer, `act` between layers and
    `final_act` (if any) after the last."""
    n = len([k for k in params if k.startswith("w")])
    for i in range(n):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The reference's cast order: the variance in float32, the product
    `x * rsqrt(var + eps)` in float32, rounded to x's dtype, then scaled."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) * scale + bias over the last axis, the
    variance biased (the reference's `jnp.var`)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross-entropy; logits (..., V), labels (...) integer.
    On DTensor logits each rank sums its own tokens' NLL (a local region)
    and the sums are reduced: the logits' gradient never exists whole."""
    from repro_torch.distributed import spmd

    if spmd.is_dtensor(logits):
        return _cross_entropy_sharded(logits, labels, mask)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / mask.sum().clamp(min=1.0)
    return nll.mean()


def _cross_entropy_sharded(logits, labels, mask):
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.distributed import spmd

    mesh = logits.device_mesh
    rows_pl = tuple(logits.placements)   # split by tokens only; labels follow
    lg = logits.to_local().float()
    lab = spmd.with_placements(labels, rows_pl).to_local()
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, lab[..., None].long())[..., 0]
    nll = logz - gold
    part = tuple(Partial() if isinstance(p, Shard) else Replicate() for p in rows_pl)
    repl = spmd.replicated(mesh.ndim)

    def total(x):  # the ranks' partial sums, reduced to one value on every rank
        return spmd.with_placements(spmd.local_out(x, mesh, part, ()), repl)

    if mask is None:
        return total(nll.sum()) / labels.numel()
    m = spmd.with_placements(mask, rows_pl).to_local()
    return total((nll * m).sum()) / total(m.sum()).clamp(min=1.0)
