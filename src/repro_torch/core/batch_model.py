"""Batch model graph construction (paper §3.4).

The batch B plus k auxiliary block nodes a_1..a_k form the model graph:
  - internal edges: both endpoints in B (weights preserved),
  - auxiliary edges: (v, a_i) with weight = total edge weight from v to
    already-assigned neighbors in block i,
  - edges to unassigned / still-buffered nodes are dropped (streaming),
  - aux node a_i is *pinned* to block i with node weight 0 — global block
    loads are tracked separately so they are not double counted.

BuffCut's batches are non-contiguous in the stream, so an explicit
local<->global map is used.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np

from repro_torch import tracing
from repro_torch.graphs.csr import CSRGraph

# per-thread reusable global->local map: one O(n) fill per driver run; the
# entries a build touches are reset to -1 in its finally
_TLS = threading.local()


def _local_scratch(n: int) -> np.ndarray:
    a = getattr(_TLS, "local_of", None)
    if a is None or a.shape[0] != n:
        a = np.full(n, -1, dtype=np.int64)
        _TLS.local_of = a
    return a


@dataclasses.dataclass
class BatchModel:
    graph: CSRGraph            # b + k local nodes
    batch_nodes: np.ndarray    # (b,) global ids; local id i <-> batch_nodes[i]
    k: int
    pinned_block: np.ndarray   # (b+k,) -1 for free, block id for aux nodes

    @property
    def b(self) -> int:
        return int(self.batch_nodes.shape[0])


def build_batch_model(
    g: CSRGraph, batch: np.ndarray, block: np.ndarray, k: int
) -> BatchModel:
    """Graph-backed wrapper: gather the batch adjacency from the CSR, then
    defer to the adjacency-based builder the driver uses."""
    with tracing.span("batch_model.run"):
        with tracing.span("batch_model.gather"):
            batch = np.asarray(batch, dtype=np.int64)
            degs = (g.indptr[batch + 1] - g.indptr[batch]).astype(np.int64)
            gather = g.slice_indices(batch)
            dst_g = g.indices[gather].astype(np.int64)
            w = g.edge_w[gather].astype(np.float64)
            node_w = g.node_w[batch]
        return build_batch_model_from_adj(g.n, batch, degs, dst_g, w, node_w, block, k)


def build_batch_model_from_adj(
    n: int,
    batch: np.ndarray,
    degs: np.ndarray,
    dst_g: np.ndarray,
    w: np.ndarray,
    node_w_batch: np.ndarray,
    block: np.ndarray,
    k: int,
) -> BatchModel:
    """Build the model graph from the batch's *retained* adjacency, so no
    CSR of the full graph is required."""
    with tracing.span("batch_model.gather"):
        batch = np.asarray(batch, dtype=np.int64)
        b = batch.shape[0]
        local_of = _local_scratch(n)
        try:
            local_of[batch] = np.arange(b)
            dst_l = local_of[dst_g]
        finally:
            local_of[batch] = -1
        src_l = np.repeat(np.arange(b, dtype=np.int64), degs)

        internal = dst_l >= 0
        int_src, int_dst, int_w = src_l[internal], dst_l[internal], w[internal]
        keep = int_src < int_dst  # one canonical direction; from_edges symmetrizes
        int_edges = np.stack([int_src[keep], int_dst[keep]], axis=1)
        int_w = int_w[keep]

    # aux edges: per-(node, block) weight through one composite-key bincount
    with tracing.span("batch_model.aux"):
        ext = ~internal
        dst_blk = block[dst_g[ext]]
        assigned = dst_blk >= 0
        key = src_l[ext][assigned] * np.int64(k) + dst_blk[assigned]
        aux_w = np.bincount(key, weights=w[ext][assigned], minlength=b * k)
        aux_w = aux_w.reshape(b, k)
        ai, ab = np.nonzero(aux_w)
        aux_edges = np.stack([ai, b + ab], axis=1)
        aux_wts = aux_w[ai, ab].astype(np.float32)

    with tracing.span("batch_model.csr"):
        edges = (np.concatenate([int_edges, aux_edges], axis=0) if b
                 else np.empty((0, 2), dtype=np.int64))
        wts = np.concatenate([int_w, aux_wts], axis=0)
        node_w = np.concatenate([np.asarray(node_w_batch, dtype=np.float32),
                                 np.zeros(k, dtype=np.float32)])
        model = CSRGraph.from_edges(b + k, edges, edge_weights=wts, node_weights=node_w)

    pinned = np.full(b + k, -1, dtype=np.int64)
    pinned[b:] = np.arange(k)
    return BatchModel(graph=model, batch_nodes=batch, k=k, pinned_block=pinned)
