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

On a device mesh (DTensor parameters and batch, `launch/steps.py`'s DLRM
cells) the tables are split by rows over every rank and the pool is a
local region: each rank pools, for every row of the batch, the lookups
that fall in its block of rows (the bag on its local shard of the
tables), and the blocks' partial sums are reduced into the batch's
layout.  The MLPs and the interaction then run on each rank's own rows
with the replicated MLP weights.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.distributed import spmd
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
    if spmd.is_dtensor(params["tables"]):
        return _pool_sharded(params["tables"], idx, mask, bag)
    return bag(params["tables"], idx.to(torch.int32).contiguous(),
               mask.to(torch.float32).contiguous())


def _pool_sharded(tables, idx, mask, bag):
    """The pool with the tables (T, V, D) split by rows: the whole batch's
    lookups on every rank, each masked to the rank's rows, one bag call on
    the local shard, and the partial sums reduced into idx's layout."""
    mesh = tables.device_mesh
    repl = spmd.replicated(mesh.ndim)
    i_pl = tuple(idx.placements)
    ids = spmd.with_placements(idx, repl).to_local()
    m = spmd.with_placements(mask, repl).to_local()
    row0 = spmd.global_offset(tables)[1]
    loc = tables.to_local()
    rows = ids.long() - row0
    mine = (rows >= 0) & (rows < loc.shape[1])
    local_ids = torch.where(mine, rows, 0).to(torch.int32).contiguous()
    local_mask = (m.to(torch.float32) * mine.to(torch.float32)).contiguous()
    pooled = bag(loc, local_ids, local_mask)                     # partial over row blocks
    t_pl = tuple(tables.placements)
    pl = tuple(Partial() if isinstance(p, Shard) else Replicate() for p in t_pl)
    out = spmd.local_out(pooled, mesh, pl, (*idx.shape[:2], tables.shape[2]))
    return spmd.with_placements(out, i_pl)


def _dense(params: dict, dense: torch.Tensor, sparse_v: torch.Tensor) -> torch.Tensor:
    dense_v = mlp_apply(params["bot"], dense, act=torch.relu, final_act=torch.relu)
    z = _interact(dense_v, sparse_v)
    top_in = torch.cat([dense_v, z], dim=-1)
    return mlp_apply(params["top"], top_in, act=torch.relu)[:, 0]


def _forward(params: dict, batch: dict, bag) -> torch.Tensor:
    sparse_v = _pool(params, batch["sparse_idx"], batch["sparse_mask"], bag)  # (B, 26, D)
    if not spmd.is_dtensor(sparse_v):
        return _dense(params, batch["dense"], sparse_v)
    # on a mesh: each rank's own rows, the MLP weights whole (their
    # gradients partial over the ranks that split the batch)
    mesh = sparse_v.device_mesh
    b_pl = tuple(sparse_v.placements)
    split = spmd.split_mesh_dims(b_pl)
    repl = spmd.replicated(mesh.ndim)
    mlps = {k: {n: spmd.local_in(w, repl, split) for n, w in params[k].items()}
            for k in ("bot", "top")}
    dense = spmd.local_in(batch["dense"], b_pl)
    logits = _dense(mlps, dense, sparse_v.to_local())
    return spmd.local_out(logits, mesh, b_pl, (sparse_v.shape[0],))


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
    sparse_v = _pool(params, batch["query_sparse_idx"], batch["query_sparse_mask"],
                     embedding_bag)
    if not spmd.is_dtensor(sparse_v):
        dense_v = mlp_apply(params["bot"], batch["query_dense"], act=torch.relu,
                            final_act=torch.relu)
        user = dense_v[0] + sparse_v[0].mean(dim=0)  # (D,) pooled user tower
        return batch["candidates"] @ user
    # on a mesh: the query's tower on every rank, each rank's candidates
    mesh = sparse_v.device_mesh
    repl = spmd.replicated(mesh.ndim)
    cand = batch["candidates"]
    c_pl = tuple(cand.placements)
    bot = {n: spmd.local_in(w, repl) for n, w in params["bot"].items()}
    dense_v = mlp_apply(bot, spmd.local_in(batch["query_dense"], repl), act=torch.relu,
                        final_act=torch.relu)
    user = dense_v[0] + spmd.local_in(sparse_v, repl)[0].mean(dim=0)
    return spmd.local_out(cand.to_local() @ user, mesh, c_pl, (cand.shape[0],))
