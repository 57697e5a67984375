"""Synthetic graph generators (the families the smoke run and tests use).

Each one draws the same numbers as `repro.graphs.generators` at equal
seeds, so both packages build identical arrays.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.csr import CSRGraph


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
