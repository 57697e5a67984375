"""Node-streaming protocol — the partitioner's only view of the graph.

Nodes arrive strictly in id order as (node_id, neighbor_ids,
neighbor_weights, node_weight) tuples; global aggregates (`n`, `m`,
`n_total`, `m_total`) are available before the first record, and
`resident_bytes` reports the bytes the stream itself holds (0 for the
in-memory stream: the wrapped graph is the input, not partitioner state).
`NodeStream` wraps an in-memory graph; `DiskNodeStream`
(graphs/stream_io.py) parses a file incrementally and never holds the CSR.

`n_total` / `m_total` are float64 sums computed the same way from the same
per-row values as the reference stream (`canonical_totals`), so
`FennelParams` — and every assignment decision downstream — is
bit-identical to `repro`'s, and between a graph in memory and its file.
"""
from __future__ import annotations

from collections.abc import Iterator

import numpy as np

from repro_torch.graphs.csr import CSRGraph


def seq_sum64(a: np.ndarray) -> float:
    """Sequential (left-to-right) float64 sum of a 1-D array.

    np.bincount accumulates strictly in input order, unlike np.sum's
    pairwise reduction — the summation order `weighted_degrees` uses too.
    """
    if a.size == 0:
        return 0.0
    return float(
        np.bincount(np.zeros(a.shape[0], dtype=np.int64), weights=a.astype(np.float64), minlength=1)[0]
    )


def canonical_totals(deg_w: np.ndarray, node_w: np.ndarray) -> tuple[float, float]:
    """(n_total, m_total) from per-node weighted degrees and node weights."""
    n_total = float(np.sum(node_w.astype(np.float64)))
    m_total = float(np.sum(deg_w.astype(np.float64)) / 2.0)
    return n_total, m_total


class NodeStreamBase:
    """Protocol for node streams: subclasses set `n` and `m` and implement
    `__iter__` and the aggregate properties; seekable streams also
    implement `tell` and `iter_from`."""

    n: int
    m: int
    # whether the stream carries non-unit edge / node weights (writers pick
    # the packed-format flags from these); conservative default
    has_edge_w: bool = True
    has_node_w: bool = True

    @property
    def n_total(self) -> float:
        raise NotImplementedError

    @property
    def m_total(self) -> float:
        raise NotImplementedError

    @property
    def resident_bytes(self) -> int:
        return 0

    @property
    def bytes_read(self) -> int:
        return 0

    @property
    def io_retries(self) -> int:
        return 0

    def __iter__(self) -> Iterator[tuple[int, np.ndarray, np.ndarray, float]]:
        raise NotImplementedError

    # -------------------------------------------------- resumable iteration
    def tell(self) -> dict:
        """Resume token for the record *after* the last one yielded by the
        active iteration: a JSON-able dict carrying at least ``index``, the
        next record's node id."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support positioned iteration"
        )

    def iter_from(self, pos: dict) -> Iterator[tuple[int, np.ndarray, np.ndarray, float]]:
        """Iterate records starting at a `tell()` token, bit-identical to
        the tail of a full iteration."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support positioned iteration"
        )

    def chunks(self, chunk: int) -> Iterator[dict]:
        """Yield contiguous chunks as padded-ELL dicts (generic path)."""
        pend: list[tuple[int, np.ndarray, np.ndarray, float]] = []
        for rec in self:
            pend.append(rec)
            if len(pend) == chunk:
                yield _ell_chunk(pend)
                pend = []
        if pend:
            yield _ell_chunk(pend)


def _ell_chunk(records: list[tuple[int, np.ndarray, np.ndarray, float]]) -> dict:
    """Pad a list of stream records into the ELL dict `CSRGraph.ell_block`
    produces (same -1 / 0 padding, same width rounding)."""
    rows = len(records)
    w = max(8, ((max((r[1].size for r in records), default=1) + 7) // 8) * 8)
    nbr = np.full((rows, w), -1, dtype=np.int32)
    wts = np.zeros((rows, w), dtype=np.float32)
    node_w = np.empty(rows, dtype=np.float32)
    nodes = np.empty(rows, dtype=np.int64)
    for i, (v, nb, nw_, vw) in enumerate(records):
        d = nb.size
        nbr[i, :d] = nb
        wts[i, :d] = nw_
        node_w[i] = vw
        nodes[i] = v
    return {"nodes": nodes, "nbr": nbr, "nbr_w": wts, "mask": nbr >= 0, "node_w": node_w}


class NodeStream(NodeStreamBase):
    """In-memory stream over nodes 0..n-1 of `g` in id order."""

    def __init__(self, g: CSRGraph):
        self._g = g
        self.n = g.n
        self.m = g.m
        self._cursor = 0
        self.has_edge_w = not np.all(g.edge_w == 1.0)
        self.has_node_w = not np.all(g.node_w == 1.0)
        self._totals: tuple[float, float] | None = None

    def _compute_totals(self) -> tuple[float, float]:
        if self._totals is None:
            g = self._g
            deg_w = np.bincount(
                np.repeat(np.arange(g.n, dtype=np.int64), np.diff(g.indptr)),
                weights=g.edge_w.astype(np.float64),
                minlength=g.n,
            )
            self._totals = canonical_totals(deg_w, g.node_w)
        return self._totals

    @property
    def n_total(self) -> float:
        return self._compute_totals()[0]

    @property
    def m_total(self) -> float:
        return self._compute_totals()[1]

    def __iter__(self) -> Iterator[tuple[int, np.ndarray, np.ndarray, float]]:
        return self.iter_from({"index": 0})

    def tell(self) -> dict:
        return {"index": self._cursor}

    def iter_from(self, pos: dict) -> Iterator[tuple[int, np.ndarray, np.ndarray, float]]:
        g = self._g
        for v in range(int(pos["index"]), g.n):
            self._cursor = v + 1
            yield v, g.neighbors(v), g.neighbor_weights(v), float(g.node_w[v])

    def chunks(self, chunk: int) -> Iterator[dict]:
        """Yield contiguous chunks as padded-ELL dicts (vectorized path)."""
        g = self._g
        for start in range(0, g.n, chunk):
            nodes = np.arange(start, min(start + chunk, g.n), dtype=np.int64)
            nbr, wts, mask = g.ell_block(nodes)
            yield {
                "nodes": nodes,
                "nbr": nbr,
                "nbr_w": wts,
                "mask": mask,
                "node_w": g.node_w[nodes],
            }



class StreamShard(NodeStreamBase):
    """A contiguous id-range view [lo, hi) of a replayable parent stream.

    The sharded driver (distributed/shard_driver.py) hands one of these to
    each worker: records stream exactly as the parent would yield them for
    ids lo..hi-1, but the *aggregates* stay global — ``n`` sizes the label
    array and ``n_total``/``m_total`` feed `FennelParams`, so every worker
    scores against the same whole-graph balance targets the sequential
    driver uses (a shard-local n would skew gamma and the load cap).

    ``make_iter`` is a zero-argument factory returning a fresh record
    iterator positioned at record ``lo`` (``NodeStream.iter_from`` for
    in-memory parents, ``DiskNodeStream.iter_from(token)`` for disk parents
    — the boundary token comes from `graphs.stream_io.shard_boundary_pass`).
    Iteration stops after ``hi - lo`` records; a parent that runs out
    earlier raises (truncated shard), never a silent short stream.  Each
    `StreamShard` owns its parent handle, so per-worker IO accounting
    (`resident_bytes`, `bytes_read`, `io_retries`) is private to the shard.
    """

    def __init__(self, parent: NodeStreamBase, make_iter, lo: int, hi: int):
        if not (0 <= lo <= hi <= parent.n):
            raise ValueError(
                f"shard range [{lo}, {hi}) is outside the stream's [0, {parent.n})"
            )
        self._parent = parent
        self._make_iter = make_iter
        self.lo = int(lo)
        self.hi = int(hi)
        self.n = parent.n
        self.m = parent.m
        self.has_edge_w = parent.has_edge_w
        self.has_node_w = parent.has_node_w
        self._totals = (parent.n_total, parent.m_total)

    @property
    def n_local(self) -> int:
        return self.hi - self.lo

    @property
    def n_total(self) -> float:
        return self._totals[0]

    @property
    def m_total(self) -> float:
        return self._totals[1]

    @property
    def resident_bytes(self) -> int:
        return self._parent.resident_bytes

    @property
    def bytes_read(self) -> int:
        return self._parent.bytes_read

    @property
    def io_retries(self) -> int:
        return self._parent.io_retries

    def __iter__(self) -> Iterator[tuple[int, np.ndarray, np.ndarray, float]]:
        seen = 0
        for rec in self._make_iter():
            if rec[0] != self.lo + seen:
                raise ValueError(
                    f"shard [{self.lo}, {self.hi}) expected record "
                    f"{self.lo + seen}, parent yielded {rec[0]}: the shard "
                    "iterator factory is positioned wrong"
                )
            yield rec
            seen += 1
            if seen == self.n_local:
                return
        raise ValueError(
            f"shard [{self.lo}, {self.hi}) ended after {seen} of "
            f"{self.n_local} records: the parent stream was truncated"
        )

def as_node_stream(g: "CSRGraph | NodeStreamBase") -> NodeStreamBase:
    """Drivers accept either a CSRGraph (wrapped in-memory) or any stream."""
    if isinstance(g, NodeStreamBase):
        return g
    if isinstance(g, CSRGraph):
        return NodeStream(g)
    raise TypeError(f"expected CSRGraph or NodeStreamBase, got {type(g).__name__}")
