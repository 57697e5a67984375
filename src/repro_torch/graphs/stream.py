"""Node-streaming protocol — the partitioner's only view of the graph.

Nodes arrive strictly in id order as (node_id, neighbor_ids,
neighbor_weights, node_weight) tuples; global aggregates (`n`, `m`,
`n_total`, `m_total`) are available before the first record, and
`resident_bytes` reports the bytes the stream itself holds (0 for the
in-memory stream: the wrapped graph is the input, not partitioner state).

`n_total` / `m_total` are float64 sums computed the same way from the same
per-row values as the reference stream (`canonical_totals`), so
`FennelParams` — and every assignment decision downstream — is
bit-identical to `repro`'s.
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


class NodeStream(NodeStreamBase):
    """In-memory stream over nodes 0..n-1 of `g` in id order."""

    def __init__(self, g: CSRGraph):
        self._g = g
        self.n = g.n
        self.m = g.m
        self._cursor = 0
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


def as_node_stream(g: "CSRGraph | NodeStreamBase") -> NodeStreamBase:
    """Drivers accept either a CSRGraph (wrapped in-memory) or any stream."""
    if isinstance(g, NodeStreamBase):
        return g
    if isinstance(g, CSRGraph):
        return NodeStream(g)
    raise TypeError(f"expected CSRGraph or NodeStreamBase, got {type(g).__name__}")
