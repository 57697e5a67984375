"""Synthetic graph generators mirroring the paper's instance families, and
writers that stream a structured family straight to a packed file.

Each one draws the same numbers as `repro.graphs.generators` at equal
seeds, so both packages build identical arrays.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.csr import CSRGraph
from repro_torch.graphs.stream_io import PackedWriter, write_packed


def rmat_graph(
    n: int,
    avg_degree: int,
    *,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
) -> CSRGraph:
    """R-MAT power-law graph (social/web family). n rounded up to a power of 2."""
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(n, 2))))
    n = 1 << scale
    n_edges = n * avg_degree // 2
    src = np.zeros(n_edges, dtype=np.int64)
    dst = np.zeros(n_edges, dtype=np.int64)
    probs = np.array([a, b, c, 1.0 - a - b - c])
    for _level in range(scale):
        quad = rng.choice(4, size=n_edges, p=probs)
        src = (src << 1) | (quad >> 1)
        dst = (dst << 1) | (quad & 1)
    return CSRGraph.from_edges(n, np.stack([src, dst], axis=1))


def rgg_graph(n: int, radius: float | None = None, *, seed: int = 0) -> CSRGraph:
    """Random geometric graph in the unit square (paper's rgg26 family)."""
    rng = np.random.default_rng(seed)
    if radius is None:
        radius = np.sqrt(8.0 / n)  # avg degree ~ pi * r^2 * n ~ 25
    pts = rng.random((n, 2))
    # grid binning for near-linear neighbor search
    cell = radius
    gx = np.floor(pts[:, 0] / cell).astype(np.int64)
    gy = np.floor(pts[:, 1] / cell).astype(np.int64)
    ncell = int(np.ceil(1.0 / cell)) + 1
    cell_id = gx * ncell + gy
    order = np.argsort(cell_id, kind="stable")
    sorted_cells = cell_id[order]
    starts = np.searchsorted(sorted_cells, np.arange(ncell * ncell))
    ends = np.searchsorted(sorted_cells, np.arange(ncell * ncell), side="right")
    edges = []
    r2 = radius * radius
    for i in range(n):
        cx, cy = gx[i], gy[i]
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                nx_, ny_ = cx + dx, cy + dy
                if nx_ < 0 or ny_ < 0 or nx_ >= ncell or ny_ >= ncell:
                    continue
                cid = nx_ * ncell + ny_
                cand = order[starts[cid] : ends[cid]]
                cand = cand[cand > i]
                if cand.size == 0:
                    continue
                d2 = ((pts[cand] - pts[i]) ** 2).sum(axis=1)
                for j in cand[d2 <= r2]:
                    edges.append((i, j))
    if not edges:
        edges = [(0, min(1, n - 1))]
    return CSRGraph.from_edges(n, np.array(edges, dtype=np.int64))


def rhg_like_graph(n: int, avg_degree: int, *, gamma: float = 2.7, seed: int = 0) -> CSRGraph:
    """Random hyperbolic-like graph via Chung-Lu with power-law weights.

    A faithful RHG sampler (paper's rhg1B/rhg2B) needs hyperbolic geometry;
    Chung-Lu with the same degree exponent reproduces the degree profile and
    community-ish clustering relevant to partitioning benchmarks.
    """
    rng = np.random.default_rng(seed)
    # power-law expected degrees
    u = rng.random(n)
    wmin = avg_degree * (gamma - 2) / (gamma - 1)
    weights = wmin / np.power(1.0 - u, 1.0 / (gamma - 1.0))
    weights = np.minimum(weights, np.sqrt(weights.sum()))
    total = weights.sum()
    n_edges = int(total / 2)
    p = weights / total
    src = rng.choice(n, size=n_edges, p=p)
    dst = rng.choice(n, size=n_edges, p=p)
    # locality: sort nodes by weight so ids correlate with structure
    return CSRGraph.from_edges(n, np.stack([src, dst], axis=1))


def grid_mesh_graph(side: int, *, diag: bool = True) -> CSRGraph:
    """2D grid mesh (paper's Flan/Bump mesh family). n = side*side."""
    n = side * side
    idx = np.arange(n).reshape(side, side)
    edges = [
        np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1),
        np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1),
    ]
    if diag:
        edges.append(np.stack([idx[:-1, :-1].ravel(), idx[1:, 1:].ravel()], axis=1))
    return CSRGraph.from_edges(n, np.concatenate(edges, axis=0))


def sbm_graph(
    n: int,
    n_blocks: int,
    *,
    p_in: float = 0.05,
    p_out: float = 0.001,
    seed: int = 0,
) -> CSRGraph:
    """Stochastic block model with ground-truth communities."""
    rng = np.random.default_rng(seed)
    block = np.repeat(np.arange(n_blocks), n // n_blocks + 1)[:n]
    edges = []
    for b in range(n_blocks):
        members = np.where(block == b)[0]
        nb = members.size
        n_e = int(p_in * nb * (nb - 1) / 2)
        if n_e and nb > 1:
            s = members[rng.integers(0, nb, n_e)]
            d = members[rng.integers(0, nb, n_e)]
            edges.append(np.stack([s, d], axis=1))
    n_e = int(p_out * n * n / 2)
    if n_e:
        s = rng.integers(0, n, n_e)
        d = rng.integers(0, n, n_e)
        edges.append(np.stack([s, d], axis=1))
    return CSRGraph.from_edges(n, np.concatenate(edges, axis=0))


# ------------------------------------------------------- generate-to-disk
#
# Out-of-core benchmarks need graphs several times larger than the
# partitioner's configured buffer without ever materializing them.  The
# structured families (grid, ring) emit their canonical CSR rows directly —
# node v's neighbors in exactly the order `CSRGraph.from_edges` would store
# them (ids > v ascending, then < v ascending) — so one record is resident
# at a time and the disk stream is bit-identical to the in-memory graph.
# Random families require global dedup/symmetrization, so `generate_to_disk`
# materializes those at container scale and converts (documented fallback).


def grid_mesh_to_disk(side: int, path: str, *, diag: bool = True) -> int:
    """Stream a 2D grid mesh (n = side*side) straight to a packed file.

    Rows match `grid_mesh_graph(side, diag=diag)` exactly; peak memory is
    O(n) bookkeeping in the writer (totals), never O(m).
    """
    n = side * side
    m = 2 * side * (side - 1) + (diag * (side - 1) * (side - 1))
    with PackedWriter(path, n, m, has_edge_w=False, has_node_w=False) as w:
        for r in range(side):
            for c in range(side):
                v = r * side + c
                row: list[int] = []
                if c < side - 1:
                    row.append(v + 1)
                if r < side - 1:
                    row.append(v + side)
                if diag and r < side - 1 and c < side - 1:
                    row.append(v + side + 1)
                if diag and r > 0 and c > 0:
                    row.append(v - side - 1)
                if r > 0:
                    row.append(v - side)
                if c > 0:
                    row.append(v - 1)
                w.write_node(np.asarray(row, dtype=np.int64))
    return n


def ring_to_disk(n: int, path: str) -> int:
    """Stream a ring graph to a packed file (rows match `ring_graph(n)`)."""
    if n < 3:
        raise ValueError("ring_to_disk needs n >= 3")
    with PackedWriter(path, n, n, has_edge_w=False, has_node_w=False) as w:
        for v in range(n):
            if v == 0:
                row = [1, n - 1]
            elif v == n - 1:
                row = [0, n - 2]
            else:
                row = [v + 1, v - 1]
            w.write_node(np.asarray(row, dtype=np.int64))
    return n


_DISK_FAMILIES = {
    "grid": lambda path, **kw: grid_mesh_to_disk(kw.pop("side"), path, **kw),
    "ring": lambda path, **kw: ring_to_disk(kw.pop("n"), path, **kw),
}


def generate_to_disk(family: str, path: str, **params) -> int:
    """Synthesize a graph family straight to a packed file; returns n.

    'grid' and 'ring' stream incrementally (graphs larger than RAM are
    fine); other families build in memory first and convert.
    """
    if family in _DISK_FAMILIES:
        return _DISK_FAMILIES[family](path, **params)
    builders = {
        "rmat": rmat_graph, "rgg": rgg_graph, "rhg": rhg_like_graph,
        "sbm": sbm_graph, "star": star_graph,
    }
    if family not in builders:
        raise ValueError(f"unknown family {family!r} (have {sorted(builders) + sorted(_DISK_FAMILIES)})")
    g = builders[family](**params)
    write_packed(g, path)
    return g.n


def star_graph(n: int) -> CSRGraph:
    """Hub + leaves: exercises the D_max hub bypass path."""
    edges = np.stack([np.zeros(n - 1, dtype=np.int64), np.arange(1, n)], axis=1)
    return CSRGraph.from_edges(n, edges)


def ring_graph(n: int) -> CSRGraph:
    src = np.arange(n, dtype=np.int64)
    dst = (src + 1) % n
    return CSRGraph.from_edges(n, np.stack([src, dst], axis=1))
