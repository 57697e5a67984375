"""CSR graph container (host numpy, as in `repro.graphs.csr`).

The streaming partitioner's host-side state is numpy; the device engine
consumes padded COO/ELL tiles extracted from this CSR and moves them to
torch tensors itself.  Graphs are undirected and simple: every edge (u, v)
is stored twice (u->v and v->u), no self loops, no parallel edges.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def bucket_size(x: int, minimum: int = 64) -> int:
    """Next power of two >= max(x, minimum) — the static-shape bucket.

    Padding device arrays to pow2 buckets keeps the set of distinct buffer
    shapes across a stream of batches tiny (DESIGN.md §3.5).
    """
    return 1 << max(int(x) - 1, max(minimum, 1) - 1).bit_length()


@dataclasses.dataclass
class CSRGraph:
    """Undirected graph in CSR form.

    indptr:   (n+1,) int64 — neighbor-list offsets.
    indices:  (2m,)  int32 — concatenated neighbor lists.
    edge_w:   (2m,)  float32 — per-direction edge weight (symmetric).
    node_w:   (n,)   float32 — node weights (unit by default).
    """

    indptr: np.ndarray
    indices: np.ndarray
    edge_w: np.ndarray
    node_w: np.ndarray

    @property
    def n(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def m(self) -> int:
        """Number of undirected edges."""
        return int(self.indices.shape[0] // 2)

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int64)

    @property
    def max_degree(self) -> int:
        return int(self.degrees.max(initial=0))

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v] : self.indptr[v + 1]]

    def neighbor_weights(self, v: int) -> np.ndarray:
        return self.edge_w[self.indptr[v] : self.indptr[v + 1]]

    def slice_indices(self, nodes: np.ndarray) -> np.ndarray:
        """Flat CSR positions of all edges incident to `nodes`, in node
        order then CSR order, without a Python loop."""
        nodes = np.asarray(nodes, dtype=np.int64)
        degs = self.indptr[nodes + 1] - self.indptr[nodes]
        total = int(degs.sum())
        if total == 0:
            return np.empty(0, dtype=np.int64)
        seg_start = np.repeat(np.cumsum(degs) - degs, degs)
        return np.arange(total, dtype=np.int64) - seg_start + np.repeat(self.indptr[nodes], degs)

    def total_edge_weight(self) -> float:
        return float(self.edge_w.astype(np.float64).sum() / 2.0)

    def validate(self) -> None:
        n = self.n
        assert self.indptr[0] == 0 and self.indptr[-1] == self.indices.shape[0]
        assert (np.diff(self.indptr) >= 0).all()
        assert self.indices.min(initial=0) >= 0
        assert self.indices.max(initial=-1) < n
        assert self.edge_w.shape == self.indices.shape
        assert self.node_w.shape == (n,)
        # no self loops: a spot check, the full check is O(m)
        for v in range(min(n, 64)):
            assert v not in self.neighbors(v), f"self loop at {v}"

    @staticmethod
    def from_edges(
        n: int,
        edges: np.ndarray,
        edge_weights: np.ndarray | None = None,
        node_weights: np.ndarray | None = None,
    ) -> "CSRGraph":
        """Build from an (E, 2) array of undirected edges.

        Self loops and duplicate/parallel edges are removed (the first
        weight of a duplicate wins); each surviving undirected edge
        contributes two CSR entries, rows in canonical order (stable sort
        of the symmetrized (lo, hi) then (hi, lo) list).
        """
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        if edge_weights is None:
            edge_weights = np.ones(edges.shape[0], dtype=np.float32)
        edge_weights = np.asarray(edge_weights, dtype=np.float32)
        keep = edges[:, 0] != edges[:, 1]
        edges, edge_weights = edges[keep], edge_weights[keep]
        lo = np.minimum(edges[:, 0], edges[:, 1])
        hi = np.maximum(edges[:, 0], edges[:, 1])
        key = lo * n + hi
        order = np.argsort(key, kind="stable")
        key, lo, hi, edge_weights = key[order], lo[order], hi[order], edge_weights[order]
        uniq = np.ones(key.shape[0], dtype=bool)
        uniq[1:] = key[1:] != key[:-1]
        lo, hi, edge_weights = lo[uniq], hi[uniq], edge_weights[uniq]
        src = np.concatenate([lo, hi])
        dst = np.concatenate([hi, lo])
        w = np.concatenate([edge_weights, edge_weights])
        order = np.argsort(src, kind="stable")
        src, dst, w = src[order], dst[order], w[order]
        counts = np.bincount(src, minlength=n)
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        if node_weights is None:
            node_weights = np.ones(n, dtype=np.float32)
        return CSRGraph(
            indptr=indptr,
            indices=dst.astype(np.int32),
            edge_w=w.astype(np.float32),
            node_w=np.asarray(node_weights, dtype=np.float32),
        )

    def to_edge_list(self) -> np.ndarray:
        """Return the (m, 2) canonical (u < v) undirected edge list."""
        src = np.repeat(np.arange(self.n, dtype=np.int64), np.diff(self.indptr))
        dst = self.indices.astype(np.int64)
        mask = src < dst
        return np.stack([src[mask], dst[mask]], axis=1)

    # ---------------------------------------------------------- padded tiles
    def to_coo_padded(
        self, n_pad: int, e_pad: int
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Directed edge list padded to a fixed (bucketed) shape.

        Returns (src, dst, w) of length `e_pad`; padding entries carry the
        sentinel src = dst = `n_pad` and w = 0, so segment reductions over
        n_pad + 1 segments drop them for free.
        """
        e = int(self.indices.size)
        if e > e_pad:
            raise ValueError(f"e_pad {e_pad} < directed edge count {e}")
        if self.n > n_pad:
            raise ValueError(f"n_pad {n_pad} < node count {self.n}")
        src = np.full(e_pad, n_pad, dtype=np.int64)
        dst = np.full(e_pad, n_pad, dtype=np.int64)
        w = np.zeros(e_pad, dtype=np.float64)
        src[:e] = np.repeat(np.arange(self.n, dtype=np.int64), np.diff(self.indptr))
        dst[:e] = self.indices.astype(np.int64)
        w[:e] = self.edge_w.astype(np.float64)
        return src, dst, w

    def to_ell_padded(
        self,
        nodes: np.ndarray | None = None,
        *,
        row_bucket: int | None = None,
        width_bucket: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Bucketed padded ELL tiles: `ell_block` with pow2-rounded shapes.

        Rows pad to `row_bucket` (default: bucket_size(len(nodes), 8)) with
        all-invalid rows, width to `width_bucket` (default: bucket_size of
        the max degree, min 8).
        """
        if nodes is None:
            nodes = np.arange(self.n, dtype=np.int64)
        nodes = np.asarray(nodes, dtype=np.int64)
        degs = self.indptr[nodes + 1] - self.indptr[nodes]
        if width_bucket is None:
            width_bucket = bucket_size(int(degs.max(initial=1)), minimum=8)
        if row_bucket is None:
            row_bucket = bucket_size(nodes.shape[0], minimum=8)
        if row_bucket < nodes.shape[0]:
            raise ValueError(f"row_bucket {row_bucket} < rows {nodes.shape[0]}")
        nbr, wts, mask = self.ell_block(nodes, pad_width=width_bucket)
        pad = row_bucket - nodes.shape[0]
        if pad:
            nbr = np.concatenate([nbr, np.full((pad, nbr.shape[1]), -1, dtype=nbr.dtype)])
            wts = np.concatenate([wts, np.zeros((pad, wts.shape[1]), dtype=wts.dtype)])
            mask = nbr >= 0
        return nbr, wts, mask

    def ell_block(
        self, nodes: np.ndarray, pad_width: int | None = None
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Extract padded (|nodes|, W) neighbor/weight tiles.

        Returns (nbr_ids, nbr_w, valid_mask); padding uses nbr_id = -1.
        W = max degree among `nodes` rounded up to a multiple of 8 unless
        `pad_width` is given; rows longer than W are truncated.
        """
        nodes = np.asarray(nodes, dtype=np.int64)
        degs = (self.indptr[nodes + 1] - self.indptr[nodes]).astype(np.int64)
        w = int(degs.max(initial=1)) if pad_width is None else int(pad_width)
        w = max(8, ((w + 7) // 8) * 8)
        nbr = np.full((nodes.shape[0], w), -1, dtype=np.int32)
        wts = np.zeros((nodes.shape[0], w), dtype=np.float32)
        degs_c = np.minimum(degs, w)
        total = int(degs_c.sum())
        if total:
            seg_start = np.repeat(np.cumsum(degs_c) - degs_c, degs_c)
            col = np.arange(total, dtype=np.int64) - seg_start
            pos = col + np.repeat(self.indptr[nodes], degs_c)
            row = np.repeat(np.arange(nodes.shape[0], dtype=np.int64), degs_c)
            nbr[row, col] = self.indices[pos]
            wts[row, col] = self.edge_w[pos]
        return nbr, wts, nbr >= 0
