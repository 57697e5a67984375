"""Partition quality metrics: edge cut, balance, IER (paper Eq. 7)."""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.csr import CSRGraph


def edge_cut(g: CSRGraph, block: np.ndarray) -> float:
    """Total weight of edges crossing blocks."""
    src = np.repeat(np.arange(g.n, dtype=np.int64), np.diff(g.indptr))
    dst = g.indices.astype(np.int64)
    cut = (block[src] != block[dst]) & (src < dst)
    return float(g.edge_w[cut].astype(np.float64).sum())


def cut_ratio(g: CSRGraph, block: np.ndarray) -> float:
    tw = g.total_edge_weight()
    return edge_cut(g, block) / tw if tw > 0 else 0.0


def block_loads(g: CSRGraph, block: np.ndarray, k: int) -> np.ndarray:
    loads = np.zeros(k, dtype=np.float64)
    assigned = block >= 0
    np.add.at(loads, block[assigned], g.node_w[assigned])
    return loads


def l_max(total_weight: float, k: int, eps: float) -> float:
    """Balance cap L_max = ceil((1+eps) * c(V)/k) (paper §2.1)."""
    return float(np.ceil((1.0 + eps) * total_weight / k))


def balance(g: CSRGraph, block: np.ndarray, k: int) -> float:
    """max_i c(V_i) / (c(V)/k); 1.0 = perfectly balanced."""
    loads = block_loads(g, block, k)
    avg = g.node_w.sum() / k
    return float(loads.max() / avg) if avg > 0 else 1.0


def streaming_cut_increment(
    bnodes: np.ndarray,
    labels: np.ndarray,
    degs: np.ndarray,
    nbr: np.ndarray,
    w: np.ndarray,
    block: np.ndarray,
) -> float:
    """Exact edge-cut contribution of committing `bnodes` with `labels`,
    from the batch's retained adjacency only (call *after*
    ``block[bnodes] = labels``).

    Each undirected edge is charged once, at the commit of its
    later-assigned endpoint: edges to previously assigned nodes count in
    full, edges between batch mates appear twice in the concatenated
    adjacency and are halved, and edges to still-unassigned nodes are
    charged at that neighbor's own commit.  Summed over hubs and batches
    this reproduces `edge_cut` on the final labels.
    """
    if bnodes.shape[0] == 0:
        return 0.0
    w = np.asarray(w, dtype=np.float64)
    nbr_lab = block[nbr]
    if bnodes.shape[0] == 1:
        # hub fast path: no self loops, so no batch-mate edges
        cross = (nbr_lab >= 0) & (nbr_lab != labels[0])
        return float(np.sum(w[cross]))
    in_batch = np.zeros(block.shape[0], dtype=bool)
    in_batch[bnodes] = True
    src_lab = np.repeat(labels, degs)
    cross = (nbr_lab >= 0) & (nbr_lab != src_lab)
    mates = in_batch[nbr]
    return float(np.sum(w[cross & ~mates]) + 0.5 * np.sum(w[cross & mates]))


def internal_edge_ratio_adj(
    bnodes: np.ndarray, nbr: np.ndarray, w: np.ndarray, n: int
) -> float:
    """IER(B) (paper Eq. 7) from the batch's retained adjacency: the
    concatenated neighbor slice holds both directions of every internal
    edge (= 2*w(E(B))) and its total weight is sum_B d_w(v)."""
    in_b = np.zeros(n, dtype=bool)
    in_b[bnodes] = True
    w = np.asarray(w, dtype=np.float64)
    den = float(np.sum(w))
    num = float(np.sum(w[in_b[nbr]]))
    return num / den if den > 0 else 0.0
