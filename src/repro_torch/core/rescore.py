"""Batched rescoring over retained adjacency — the streaming-side inner op.

Every driver event (hub assignment, batch admission, buffer arrival)
rescores the buffered neighbors of the affected nodes: a vectorized
adjacency gather, masked scatter-adds into the counter vectors (host numpy,
sequential `np.add.at`), and a batched score recompute (DESIGN.md §3.4).

Drivers feed each arriving node's adjacency into `observe`; it is retained
in an `AdjacencyCache` only while the node can still be touched (buffered,
batched, or mid-hub-assignment) and released at commit.  The cache's live
byte count is the "buffer + batch" term of the paper's §4 memory
accounting.

`RescoreState` owns the per-stream counters the scores are closed-form
functions of (scores.py):

  assigned_w  — weight to assigned-or-batched neighbors (all scores),
  deg_w       — weighted degree (filled at arrival from the record),
  buffered_w  — weight to currently-buffered neighbors (NSS),
  blk_w/cmax  — per-block weight to assigned neighbors + running max (CMS).

Membership of the buffer is a dense bool mask; the vectorized driver
shares `VectorBuffer.in_buf` with it (zero-copy), the sequential and
pipelined drivers mirror their BucketPQ membership into it.

All bumps return touched node ids in first-occurrence adjacency order with
their fresh scores: the order the sequential driver issues IncreaseKey in.
The scalar twins (`*_scalar`) replay the same updates on Python floats for
the pipelined driver's per-record loop, with bit-identical results.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.scores import ScoreSpec
from repro_torch.graphs.csr import CSRGraph
from repro_torch.graphs.stream import seq_sum64

_EMPTY = np.empty(0, dtype=np.int64)
_EMPTY_W = np.empty(0, dtype=np.float64)


def weighted_degrees(g: CSRGraph) -> np.ndarray:
    """Per-node total incident edge weight, float64, summed per row in CSR
    order — the same sequential sum `RescoreState.observe` computes, so a
    graph's degrees equal the stream's bit for bit."""
    return np.bincount(
        np.repeat(np.arange(g.n, dtype=np.int64), np.diff(g.indptr)),
        weights=g.edge_w.astype(np.float64),
        minlength=g.n,
    )


def _first_occurrence(ids: np.ndarray) -> np.ndarray:
    """Deduplicate preserving first-occurrence order (adjacency order)."""
    uniq, first = np.unique(ids, return_index=True)
    return uniq[np.argsort(first, kind="stable")]


class AdjacencyCache:
    """Adjacency retained for live nodes only (buffered + current batch).

    Neighbor ids are kept as int64 and weights as float64, plus the node
    weight; `resident_bytes` is maintained incrementally.
    """

    def __init__(self) -> None:
        self._nbr: dict[int, np.ndarray] = {}
        self._w: dict[int, np.ndarray] = {}
        self._node_w: dict[int, float] = {}
        self.resident_bytes = 0

    def __len__(self) -> int:
        return len(self._nbr)

    def __contains__(self, v: int) -> bool:
        return v in self._nbr

    def put(self, v: int, nbrs: np.ndarray, weights: np.ndarray, node_w: float) -> None:
        nb = np.ascontiguousarray(nbrs, dtype=np.int64)
        w = np.ascontiguousarray(weights, dtype=np.float64)
        self._nbr[v] = nb
        self._w[v] = w
        self._node_w[v] = float(node_w)
        self.resident_bytes += nb.nbytes + w.nbytes + 32

    def drop(self, vs: np.ndarray) -> None:
        for v in np.asarray(vs, dtype=np.int64).tolist():
            nb = self._nbr.pop(v, None)
            if nb is None:
                continue
            w = self._w.pop(v)
            self._node_w.pop(v)
            self.resident_bytes -= nb.nbytes + w.nbytes + 32

    def drop_one(self, v: int) -> None:
        """Scalar `drop` for a single node (the per-record loop's hub path):
        same bookkeeping, no ndarray round-trip."""
        nb = self._nbr.pop(v, None)
        if nb is None:
            return
        w = self._w.pop(v)
        self._node_w.pop(v)
        self.resident_bytes -= nb.nbytes + w.nbytes + 32

    def slice(self, us: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Concatenated (neighbors int64, weights float64, degs int64) of
        `us` in order — the batched equivalent of a CSR slice."""
        us = np.asarray(us, dtype=np.int64)
        if us.size == 0:
            return _EMPTY, _EMPTY_W, _EMPTY
        nbs = [self._nbr[int(u)] for u in us]
        ws = [self._w[int(u)] for u in us]
        degs = np.array([b.shape[0] for b in nbs], dtype=np.int64)
        return np.concatenate(nbs), np.concatenate(ws), degs

    def node_weights(self, us: np.ndarray) -> np.ndarray:
        return np.array([self._node_w[int(u)] for u in np.asarray(us)], dtype=np.float32)


class RescoreState:
    """Stream counters + buffer membership, with batched bump updates.

    Adjacency arrives via `observe` and lives in the bounded
    AdjacencyCache (the reference's "stream mode"; its graph mode serves
    baselines that are not ported yet).  Pass `member` (e.g.
    `VectorBuffer.in_buf`) to share a membership mask zero-copy.
    """

    def __init__(self, n: int, spec: ScoreSpec, k: int, member: np.ndarray | None = None):
        self.n = n
        self.deg_w = np.zeros(n, dtype=np.float64)
        self.spec = spec
        self.k = k
        self.adj = AdjacencyCache()
        self.assigned_w = np.zeros(n, dtype=np.float64)
        self.buffered_w = np.zeros(n, dtype=np.float64) if spec.needs_buffered_count else None
        # CMS: per-buffered-node block-weight rows (bounded by buffer
        # occupancy, not n*k) + dense running max
        self.blk_w: dict[int, np.ndarray] | None = {} if spec.needs_block_counts else None
        self.cmax = np.zeros(n, dtype=np.float64) if spec.needs_block_counts else None
        self.member = np.zeros(n, dtype=bool) if member is None else member

    # ----------------------------------------------------------- streaming
    def observe(self, v: int, nbrs: np.ndarray, weights: np.ndarray, node_w: float) -> None:
        """Node `v` arrived from the stream: record its weighted degree and
        retain its adjacency until `release`."""
        self.deg_w[v] = seq_sum64(weights)
        self.adj.put(v, nbrs, weights, node_w)

    def release(self, vs: np.ndarray) -> None:
        """Nodes can no longer be touched: free their retained adjacency."""
        self.adj.drop(vs)

    # ------------------------------------------------------------- scoring
    def scores_of(self, vs: np.ndarray) -> np.ndarray:
        q = self.buffered_w[vs] if self.buffered_w is not None else 0.0
        cm = self.cmax[vs] if self.cmax is not None else 0.0
        return np.asarray(
            self.spec(self.assigned_w[vs], self.deg_w[vs], q, cm), dtype=np.float64
        )

    def score(self, v: int) -> float:
        return float(self.scores_of(np.array([v], dtype=np.int64))[0])

    # ------------------------------------------------------------- gathers
    def _buffered_slice(self, us: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(neighbor ids, weights) of buffered neighbors of `us`."""
        nbr, w, _ = self.adj.slice(us)
        keep = self.member[nbr]
        return nbr[keep], w[keep]

    # --------------------------------------------------------------- bumps
    def bump_assigned(
        self, us: np.ndarray, was_buffered: bool
    ) -> tuple[np.ndarray, np.ndarray]:
        """Nodes `us` became assigned-or-batched: credit their edge weight
        to buffered neighbors (and, for NSS, debit the buffered count when
        the bumping nodes leave the buffer).  Returns (touched, scores)."""
        us = np.asarray(us, dtype=np.int64)
        if us.size == 0:
            return _EMPTY, np.empty(0)
        nbr_b, w_b = self._buffered_slice(us)
        if nbr_b.size == 0:
            return _EMPTY, np.empty(0)
        np.add.at(self.assigned_w, nbr_b, w_b)
        if was_buffered and self.buffered_w is not None:
            np.add.at(self.buffered_w, nbr_b, -w_b)
        touched = _first_occurrence(nbr_b)
        return touched, self.scores_of(touched)

    def bump_buffered(self, vs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """NSS arrivals `vs` (not yet members): count mutual buffered
        weight both ways.  Returns (touched existing members, scores)."""
        vs = np.asarray(vs, dtype=np.int64)
        if self.buffered_w is None or vs.size == 0:
            return _EMPTY, np.empty(0)
        nbr, w, degs = self.adj.slice(vs)
        keep = self.member[nbr]
        seg = np.repeat(np.arange(vs.size, dtype=np.int64), degs)
        self.buffered_w[vs] = np.bincount(
            seg[keep], weights=w[keep], minlength=vs.size
        )
        nbr_b, w_b = nbr[keep], w[keep]
        if nbr_b.size == 0:
            return _EMPTY, np.empty(0)
        np.add.at(self.buffered_w, nbr_b, w_b)
        touched = _first_occurrence(nbr_b)
        return touched, self.scores_of(touched)

    # ------------------------------------------------- scalar twins (fused)
    # The pipelined driver's per-record loop replays the batched updates
    # above in plain Python: adds in adjacency order (what np.add.at does
    # element by element), touched nodes in first-occurrence order, scores
    # computed only after every add landed.  numpy float64 scalars and
    # Python floats run the same IEEE-754 operations, so the state and the
    # IncreaseKey sequence equal the batched versions' bit for bit.

    def observe_scalar(
        self, v: int, nbrs: np.ndarray, weights: np.ndarray, node_w: float
    ) -> None:
        """Scalar `observe`: a left-to-right Python-float sum is the same
        accumulation order as seq_sum64's bincount."""
        s = 0.0
        for x in weights.tolist():
            s += x
        self.deg_w[v] = s
        self.adj.put(v, nbrs, weights, node_w)

    def score_scalar(self, v: int, fscore) -> float:
        """`score(v)` through a `ScoreSpec.scalar_fn` closure."""
        bw, cm = self.buffered_w, self.cmax
        return fscore(
            float(self.assigned_w[v]),
            float(self.deg_w[v]),
            float(bw[v]) if bw is not None else 0.0,
            float(cm[v]) if cm is not None else 0.0,
        )

    def _rescore(self, touched: list[int], fscore, apply) -> None:
        aw, bw, cm, dw = self.assigned_w, self.buffered_w, self.cmax, self.deg_w
        for x in touched:
            apply(
                x,
                fscore(
                    float(aw[x]),
                    float(dw[x]),
                    float(bw[x]) if bw is not None else 0.0,
                    float(cm[x]) if cm is not None else 0.0,
                ),
            )

    def bump_assigned_scalar(self, u: int, was_buffered: bool, fscore, apply) -> None:
        """Scalar `bump_assigned` for one node; `apply(node, score)` is
        called in first-occurrence adjacency order after all adds — the
        IncreaseKey sequence the batched result gives."""
        nbr = self.adj._nbr.get(u)
        if nbr is None or nbr.shape[0] == 0:
            return
        w = self.adj._w[u]
        member = self.member
        aw = self.assigned_w
        bw_dec = self.buffered_w if (was_buffered and self.buffered_w is not None) else None
        touched: list[int] = []
        seen: set[int] = set()
        for x, ew in zip(nbr.tolist(), w.tolist()):
            if not member[x]:
                continue
            aw[x] = aw[x] + ew
            if bw_dec is not None:
                # np.add.at(bw, nbr_b, -w_b) adds the negation; a - b and
                # a + (-b) are the same IEEE operation for float64
                bw_dec[x] = bw_dec[x] - ew
            if x not in seen:
                seen.add(x)
                touched.append(x)
        if touched:
            self._rescore(touched, fscore, apply)

    def bump_buffered_scalar(self, v: int, fscore, apply) -> None:
        """Scalar `bump_buffered` (NSS) for one arrival.  The arrival's own
        buffered_w and the members' credits touch disjoint entries (v is
        not yet a member), so one pass accumulating both equals the batched
        bincount-then-add.at order bit for bit."""
        if self.buffered_w is None:
            return
        nbr = self.adj._nbr[v]
        w = self.adj._w[v]
        member = self.member
        bw = self.buffered_w
        s = 0.0
        touched: list[int] = []
        seen: set[int] = set()
        for x, ew in zip(nbr.tolist(), w.tolist()):
            if not member[x]:
                continue
            s += ew
            bw[x] = bw[x] + ew
            if x not in seen:
                seen.add(x)
                touched.append(x)
        bw[v] = s
        if touched:
            self._rescore(touched, fscore, apply)

    def bump_block_counts(self, u: int, blk: int) -> tuple[np.ndarray, np.ndarray]:
        """CMS: node `u` received concrete block `blk`; update the buffered
        neighbors whose majority count improved.  Returns (touched, scores)."""
        if self.blk_w is None:
            return _EMPTY, np.empty(0)
        nbr_b, w_b = self._buffered_slice(np.array([u], dtype=np.int64))
        if nbr_b.size == 0:
            return _EMPTY, np.empty(0)
        touched = []
        for w_, ew in zip(nbr_b.tolist(), w_b.tolist()):
            cnt = self.blk_w.setdefault(w_, np.zeros(self.k, dtype=np.float64))
            cnt[blk] += ew
            if cnt[blk] > self.cmax[w_]:
                self.cmax[w_] = cnt[blk]
                touched.append(w_)
        touched = np.asarray(touched, dtype=np.int64)
        return touched, self.scores_of(touched)

    def drop_block_counts(self, u: int) -> None:
        """CMS: node `u` left the buffer; free its block-count row."""
        if self.blk_w is not None:
            self.blk_w.pop(u, None)
