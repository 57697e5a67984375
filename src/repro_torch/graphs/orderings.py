"""Stream orderings (paper §2.1 / §4): source, random, KONECT, BFS.

An ordering is a permutation `perm` with perm[t] = original node id streamed
at position t. `apply_order` relabels the graph so that streaming nodes
0..n-1 of the relabeled graph reproduces the chosen order — the paper's
evaluation protocol of permuting node ids.  Each function gives the same
permutation and graph as `repro.graphs.orderings` for the same input and
seed.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.csr import CSRGraph


def source_order(g: CSRGraph) -> np.ndarray:
    return np.arange(g.n, dtype=np.int64)


def random_order(g: CSRGraph, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.permutation(g.n).astype(np.int64)


def konect_order(g: CSRGraph, seed: int = 0) -> np.ndarray:
    """KONECT-style first-appearance renumbering (paper §4): nodes are
    numbered in the order they first appear in a randomly permuted edge
    list, which destroys the locality of the source order."""
    rng = np.random.default_rng(seed)
    edges = g.to_edge_list()
    edges = edges[rng.permutation(edges.shape[0])]
    seen = np.full(g.n, -1, dtype=np.int64)
    nxt = 0
    for u, v in edges.reshape(-1, 2):
        for x in (u, v):
            if seen[x] < 0:
                seen[x] = nxt
                nxt += 1
    # isolated nodes appended at the end
    for x in np.where(seen < 0)[0]:
        seen[x] = nxt
        nxt += 1
    # seen maps old -> new position; perm[t] is the old id at position t
    perm = np.empty(g.n, dtype=np.int64)
    perm[seen] = np.arange(g.n)
    return perm


def bfs_order(g: CSRGraph, root: int = 0) -> np.ndarray:
    """BFS order: a high-locality ordering (proxy for crawl source orders)."""
    seen = np.zeros(g.n, dtype=bool)
    order = np.empty(g.n, dtype=np.int64)
    pos = 0
    for start in range(g.n):
        s = (root + start) % g.n if start == 0 else start
        if seen[s]:
            continue
        queue = [s]
        seen[s] = True
        while queue:
            nxt_queue: list[int] = []
            for u in queue:
                order[pos] = u
                pos += 1
                for w in g.neighbors(u):
                    if not seen[w]:
                        seen[w] = True
                        nxt_queue.append(int(w))
            queue = nxt_queue
    return order


def apply_order(g: CSRGraph, perm: np.ndarray) -> CSRGraph:
    """Relabel so that new node t == old node perm[t]."""
    perm = np.asarray(perm, dtype=np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0])
    new_edges = inv[g.to_edge_list()]
    if np.all(g.edge_w == 1.0):
        ew = None  # unit weights: skip the per-edge lookup
    else:
        # the canonical (u < v) entries of the CSR, in to_edge_list's order
        src = np.repeat(np.arange(g.n, dtype=np.int64), np.diff(g.indptr))
        ew = g.edge_w[src < g.indices.astype(np.int64)]
    return CSRGraph.from_edges(g.n, new_edges, edge_weights=ew, node_weights=g.node_w[perm])
