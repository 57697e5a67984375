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
        return float(np.sum(w[cross]))  # repro: noqa RPR003 -- w cast to f64 above
    in_batch = np.zeros(block.shape[0], dtype=bool)
    in_batch[bnodes] = True
    src_lab = np.repeat(labels, degs)
    cross = (nbr_lab >= 0) & (nbr_lab != src_lab)
    mates = in_batch[nbr]
    return float(  # repro: noqa RPR003 -- w cast to f64 above
        np.sum(w[cross & ~mates]) + 0.5 * np.sum(w[cross & mates]))


class IncrementalCut:
    """Exact edge-cut maintenance under batch reassignment (restreaming).

    Start from a known-exact total (`edge_cut` on a resident graph, or the
    driver's streamed `StreamStats.cut_weight`), then bracket every batch
    reassignment: `stage` while `block` still holds the batch's *old*
    labels, `commit` after the new labels are written back.  Both sides are
    computed from the batch's retained adjacency only
    (`streaming_cut_increment`), so the maintainer runs out-of-core.  The
    delta is exact because labels outside the batch are fixed during the
    reassignment: edges to out-of-batch nodes count in full on both sides,
    edges between batch mates appear twice in the slice and are halved on
    both sides, and self-loops are never cut on either side.
    """

    def __init__(self, cut0: float):
        self.cut_weight = float(cut0)
        self._staged: float | None = None

    def snapshot(self) -> float:
        """Checkpointable cut total.  Only valid between stage/commit pairs
        — a mid-bracket snapshot would double-count the staged batch on
        resume, so it's refused loudly (core/checkpoint.py callers only
        checkpoint at batch boundaries)."""
        if self._staged is not None:
            raise RuntimeError(
                "IncrementalCut.snapshot between stage and commit: checkpoint "
                "only at batch boundaries"
            )
        return self.cut_weight

    def apply_edge_delta(
        self, u: int, v: int, w: float, block: np.ndarray
    ) -> float:
        """Fold a *graph* mutation into the exact cut total: edge (u, v)
        gained `w` weight (negative `w` = weight removed, e.g. a deletion
        passes minus the edge's full current weight).  Returns the cut delta
        actually applied.

        Semantics match `edge_cut` on the mutated graph exactly:

        * self-loops (u == v) are never cut — delta 0 regardless of `w`;
        * duplicate/parallel insertions accumulate onto one undirected edge,
          so each insertion contributes its own `w` when the endpoints'
          labels differ — identical to the merged edge's total weight being
          cut once;
        * an unassigned endpoint (label -1) counts as cut only against an
          assigned one, exactly `edge_cut`'s `block[src] != block[dst]`.

        Refused mid-bracket like `snapshot`: a stage/commit reassignment is
        in flight and the staged side was computed against the pre-delta
        adjacency, so interleaving a graph mutation would corrupt the total.
        """
        if self._staged is not None:
            raise RuntimeError(
                "IncrementalCut.apply_edge_delta between stage and commit: "
                "apply graph deltas only at batch boundaries"
            )
        if u == v:
            return 0.0
        if block[u] != block[v]:
            self.cut_weight += float(w)
            return float(w)
        return 0.0

    def stage(
        self,
        bnodes: np.ndarray,
        degs: np.ndarray,
        nbr: np.ndarray,
        w: np.ndarray,
        block: np.ndarray,
    ) -> None:
        """Record the batch's cut contribution under its current labels
        (call before detaching / relabeling the batch)."""
        if self._staged is not None:
            raise RuntimeError("IncrementalCut.stage called twice without commit")
        self._staged = streaming_cut_increment(
            bnodes, block[bnodes], degs, nbr, w, block
        )

    def commit(
        self,
        bnodes: np.ndarray,
        new_labels: np.ndarray,
        degs: np.ndarray,
        nbr: np.ndarray,
        w: np.ndarray,
        block: np.ndarray,
    ) -> float:
        """Fold the batch's new contribution in (call after
        ``block[bnodes] = new_labels``).  Returns the cut delta."""
        if self._staged is None:
            raise RuntimeError("IncrementalCut.commit called before stage")
        after = streaming_cut_increment(bnodes, new_labels, degs, nbr, w, block)
        delta = after - self._staged
        self._staged = None
        self.cut_weight += delta
        return delta


def internal_edge_ratio_adj(
    bnodes: np.ndarray, nbr: np.ndarray, w: np.ndarray, n: int
) -> float:
    """IER(B) (paper Eq. 7) from the batch's retained adjacency: the
    concatenated neighbor slice holds both directions of every internal
    edge (= 2*w(E(B))) and its total weight is sum_B d_w(v)."""
    in_b = np.zeros(n, dtype=bool)
    in_b[bnodes] = True
    w = np.asarray(w, dtype=np.float64)
    den = float(np.sum(w))  # repro: noqa RPR003 -- w cast to f64 above
    num = float(np.sum(w[in_b[nbr]]))  # repro: noqa RPR003 -- w cast to f64 above
    return num / den if den > 0 else 0.0


def internal_edge_ratio(g: CSRGraph, batch: np.ndarray) -> float:
    """IER(B) = 2*w(E(B)) / sum_{v in B} d_w(v) (paper Eq. 7)."""
    in_b = np.zeros(g.n, dtype=bool)
    in_b[batch] = True
    src = np.repeat(np.arange(g.n, dtype=np.int64), np.diff(g.indptr))
    dst = g.indices.astype(np.int64)
    internal = in_b[src] & in_b[dst]
    num = float(g.edge_w[internal].astype(np.float64).sum())  # both directions: 2*w(E(B))
    den = 0.0
    for v in batch:
        den += float(g.neighbor_weights(int(v)).astype(np.float64).sum())
    return num / den if den > 0 else 0.0
