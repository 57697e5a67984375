"""DLRM [Naumov et al., arXiv:1906.00091] — MLPerf benchmark config
(counterpart of `repro/models/dlrm.py`, forward only).

Bottom MLP over 13 dense features, 26 sparse categorical features pooled
through embedding bags, dot-product feature interaction, top MLP to a
click logit.  The retrieval shape scores one query against 10^6 candidates
as one matrix-vector product.

Parameters are the reference's pytree as a dict: `tables` (T, V, D) stacked,
`bot` and `top` MLP dicts.  Both `dlrm_forward` and `dlrm_retrieval` pool
all T tables in one call of the stacked `embedding_bag` op, which on a card
is one launch of the CUDA kernel (the reference's `use_kernel` switch is
not ported: the kernel computes the same function).  `dlrm_loss`, the
training loss, pools through the bag's plain version on every device, as
the reference's does (its `dlrm_loss` calls `dlrm_forward` with the
default `use_kernel=False`): the kernel has no backward, and its op raises
on a CUDA table that requires grad.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_plain
from repro_torch.models.common import mlp_apply, mlp_init


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 128
    vocab_size: int = 1048576     # rows/table (2^20 Criteo stand-in)
    bot_mlp: tuple[int, ...] = (512, 256, 128)
    top_mlp: tuple[int, ...] = (1024, 1024, 512, 256, 1)
    multi_hot: int = 1            # lookups per sparse feature

    @property
    def n_interact(self) -> int:
        f = self.n_sparse + 1
        return f * (f - 1) // 2

    def param_count(self) -> int:
        emb = self.n_sparse * self.vocab_size * self.embed_dim
        bot = sum(
            a * b for a, b in zip((self.n_dense,) + self.bot_mlp[:-1], self.bot_mlp)
        )
        d_top_in = self.n_interact + self.embed_dim
        top = sum(
            a * b for a, b in zip((d_top_in,) + self.top_mlp[:-1], self.top_mlp)
        )
        return emb + bot + top


def dlrm_init(gen: torch.Generator, cfg: DLRMConfig) -> dict:
    """Random weights drawn from `gen` on its device: tables normal /
    sqrt(D), drawn and scaled in place on the device (at full width they
    are 13.96 GB and never exist on the host), MLPs by `mlp_init`."""
    dev = gen.device
    tables = torch.randn((cfg.n_sparse, cfg.vocab_size, cfg.embed_dim), generator=gen,
                         dtype=torch.float32, device=dev)
    tables.div_(math.sqrt(cfg.embed_dim))
    d_top_in = cfg.n_interact + cfg.embed_dim
    return {
        "tables": tables,
        "bot": mlp_init(gen, [cfg.n_dense, *cfg.bot_mlp]),
        "top": mlp_init(gen, [d_top_in, *cfg.top_mlp]),
    }


def _interact(dense_v: torch.Tensor, sparse_v: torch.Tensor) -> torch.Tensor:
    """Dot interaction: pairwise dots among [dense] + the sparse vectors,
    the strict upper triangle in row-major order (`triu_indices(k=1)`)."""
    feats = torch.cat([dense_v[:, None, :], sparse_v], dim=1)  # (B, F, D)
    f = feats.shape[1]
    dots = torch.bmm(feats, feats.transpose(1, 2))
    iu, ju = torch.triu_indices(f, f, offset=1, device=feats.device)
    return dots[:, iu, ju]  # (B, F*(F-1)/2)


def _pool(params: dict, idx: torch.Tensor, mask: torch.Tensor, bag) -> torch.Tensor:
    """(B, T, D): every table's bag, in one call of `bag` (the stacked op
    or its plain version)."""
    return bag(params["tables"], idx.to(torch.int32).contiguous(),
               mask.to(torch.float32).contiguous())


def _forward(params: dict, batch: dict, bag) -> torch.Tensor:
    dense_v = mlp_apply(params["bot"], batch["dense"], act=torch.relu, final_act=torch.relu)
    sparse_v = _pool(params, batch["sparse_idx"], batch["sparse_mask"], bag)  # (B, 26, D)
    z = _interact(dense_v, sparse_v)
    top_in = torch.cat([dense_v, z], dim=-1)
    return mlp_apply(params["top"], top_in, act=torch.relu)[:, 0]


def dlrm_forward(params: dict, batch: dict, cfg: DLRMConfig) -> torch.Tensor:
    """batch: dense (B, 13) float, sparse_idx (B, 26, M) int32,
    sparse_mask (B, 26, M) float. Returns click logits (B,)."""
    return _forward(params, batch, embedding_bag)


def dlrm_loss(params: dict, batch: dict, cfg: DLRMConfig) -> torch.Tensor:
    """Mean binary cross-entropy of the click logits, pooled through the
    plain bag (differentiable on every device; never the kernel)."""
    logits = _forward(params, batch, embedding_bag_plain)
    y = batch["labels"].to(torch.float32)
    return torch.mean(
        torch.clamp(logits, min=0) - logits * y + torch.log1p(torch.exp(-logits.abs()))
    )


def dlrm_retrieval(params: dict, batch: dict, cfg: DLRMConfig) -> torch.Tensor:
    """Score one query embedding against N candidate item embeddings.

    batch: query_dense (1, 13), query_sparse_idx/mask (1, 26, M),
    candidates (N, D). Returns scores (N,) = candidate · user-tower output.
    """
    dense_v = mlp_apply(params["bot"], batch["query_dense"], act=torch.relu,
                        final_act=torch.relu)
    sparse_v = _pool(params, batch["query_sparse_idx"], batch["query_sparse_mask"],
                     embedding_bag)
    user = dense_v[0] + sparse_v[0].mean(dim=0)  # (D,) pooled user tower
    return batch["candidates"] @ user
