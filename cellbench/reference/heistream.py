"""Plain numpy reference of HeiStream [Faraj & Schulz, JEA'22] as the
BuffCut paper runs it: the stream cut into contiguous batches of δ nodes;
each batch and k auxiliary nodes, one per block, form the batch model
(edges inside the batch keep their weight; a batch node's edges to nodes
already placed add up, per block, into one edge to that block's auxiliary
node, pinned to it); the V-cycle of `vcycle.py` labels the batch model,
and its batch nodes' labels are committed and the loads grow by them.
"""
from __future__ import annotations

import math

import numpy as np

from cellbench.reference.vcycle import Level, csr, vcycle


def batch_model(graph, lo: int, hi: int, block: np.ndarray, k: int) -> Level:
    """The model of batch [lo, hi): its nodes are 0..b-1, the blocks' auxiliary
    nodes b..b+k-1."""
    b = hi - lo
    start, end = int(graph.indptr[lo]), int(graph.indptr[hi])
    src = np.repeat(np.arange(b, dtype=np.int64), np.diff(graph.indptr[lo:hi + 1]))
    dst = graph.indices[start:end].astype(np.int64)
    w = graph.edge_w[start:end].astype(np.float64)
    inside = (dst >= lo) & (dst < hi)
    up = inside & (src < dst - lo)
    blk = np.where(inside, -1, block[dst])
    out = blk >= 0
    aux = np.bincount(src[out] * k + blk[out], weights=w[out], minlength=b * k).reshape(b, k)
    ai, ab = np.nonzero(aux)
    s = np.concatenate([src[up], ai])
    d = np.concatenate([dst[up] - lo, b + ab])
    ew = np.concatenate([w[up], aux[ai, ab]]).astype(np.float32)
    indptr, indices, ew = csr(b + k, s, d, ew)
    node_w = np.concatenate([graph.node_w[lo:hi], np.zeros(k)]).astype(np.float32)
    pinned = np.concatenate([np.full(b, -1, dtype=np.int64), np.arange(k, dtype=np.int64)])
    return Level(indptr, indices, ew, node_w, pinned)


def partition(graph, part: dict, ml: dict, *, cap: float | None = None) -> np.ndarray:
    """Labels of every node of `graph` (a `Graph` of CSR arrays) under the
    configuration's `part` (k, eps, batch_size, gamma) and `ml` (the
    V-cycle's schedule).  `cap` replaces L_max = ceil((1+eps)·c(V)/k)."""
    k, eps, gamma = int(part["k"]), float(part["eps"]), float(part["gamma"])
    n_total = float(graph.node_w.astype(np.float64).sum())
    m_total = float(graph.edge_w.astype(np.float64).sum() / 2.0)
    alpha = m_total * k ** (gamma - 1.0) / max(n_total, 1.0) ** gamma
    if cap is None:
        cap = l_max(n_total, k, eps)
    block = np.full(graph.n, -1, dtype=np.int64)
    loads = np.zeros(k, dtype=np.float64)
    delta = int(part["batch_size"])
    for lo in range(0, graph.n, delta):
        hi = min(lo + delta, graph.n)
        model = batch_model(graph, lo, hi, block, k)
        labels = vcycle(model, loads, k=k, alpha=alpha, gamma=gamma, cap=cap, ml=ml)[: hi - lo]
        block[lo:hi] = labels
        np.add.at(loads, labels, graph.node_w[lo:hi].astype(np.float64))
    return block


def l_max(n_total: float, k: int, eps: float) -> float:
    """The balance cap L_max = ceil((1 + eps) · c(V) / k)."""
    return float(math.ceil((1.0 + eps) * n_total / k))
