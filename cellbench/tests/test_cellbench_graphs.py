"""The input generators: deterministic in the seed, and the graphs they
promise (checked against brute force at small sizes)."""
from __future__ import annotations

import math

import numpy as np
import pytest

from cellbench.harness import graphs

INIT = (0.57, 0.19, 0.19, 0.05)


def same(a: graphs.Graph, b: graphs.Graph) -> bool:
    return all(x.shape == y.shape and (x == y).all() for x, y in zip(a, b))


def simple_undirected(g: graphs.Graph) -> None:
    rows = np.repeat(np.arange(g.n), np.diff(g.indptr))
    cols = g.indices.astype(np.int64)
    assert (rows != cols).all()
    key = rows * g.n + cols
    assert (np.diff(key) > 0).all()                       # rows sorted, no duplicates
    assert np.array_equal(np.sort(cols * g.n + rows), key)  # symmetric
    assert g.indices.dtype == np.int32 and g.edge_w.dtype == np.float32


@pytest.mark.parametrize("make", [
    lambda s: graphs.rgg(1 << 12, 0.55, s),
    lambda s: graphs.kronecker(10, 16, INIT, s),
    lambda s: graphs.stream_order(graphs.rgg(1 << 11, 0.55, s), "random", s),
    lambda s: graphs.stream_order(graphs.kronecker(9, 8, INIT, s), "bfs", s),
], ids=["rgg", "kronecker", "rgg-random", "kronecker-bfs"])
def test_generators_are_deterministic_in_the_seed(make):
    big = 2**31 + 11
    a, b, c = make(big), make(big), make(big + 1)
    assert same(a, b)
    assert not same(a, c)
    simple_undirected(a)


def test_rgg_is_the_radius_graph_in_cell_order():
    n, seed = 1500, 7
    g = graphs.rgg(n, 0.55, seed)
    import torch

    pts = torch.rand((n, 2), generator=graphs.torch_gen(seed, 1, "cpu"),
                     dtype=torch.float64).numpy()
    r = 0.55 * math.sqrt(math.log(n) / n)
    side = int(1.0 / r)
    cxy = np.minimum((pts * side).astype(np.int64), side - 1)
    order = np.argsort(cxy[:, 1] * side + cxy[:, 0], kind="stable")
    p = pts[order]
    d2 = ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1)
    want = (d2 <= r * r) & ~np.eye(n, dtype=bool)
    got = np.zeros((n, n), dtype=bool)
    got[np.repeat(np.arange(n), np.diff(g.indptr)), g.indices] = True
    assert np.array_equal(got, want)


def test_kronecker_has_power_law_hubs_at_low_ids():
    g = graphs.kronecker(12, 16, INIT, 5)
    deg = np.diff(g.indptr)
    assert g.n == 4096 and 0 < g.m <= 16 * 4096
    assert deg[0] == deg.max() and deg[0] > 20 * deg.mean()


@pytest.mark.parametrize("order", graphs.ORDERS)
def test_stream_orders_are_relabelings(order):
    g = graphs.kronecker(9, 8, INIT, 3)
    h = graphs.stream_order(g, order, 3)
    assert h.m == g.m
    assert np.array_equal(np.sort(np.diff(h.indptr)), np.sort(np.diff(g.indptr)))
    if order == "natural":
        assert h is g


def test_bfs_order_visits_each_node_once_neighbours_first():
    g = graphs.rgg(1 << 10, 0.55, 2)
    order = graphs.bfs_order(g)
    assert np.array_equal(np.sort(order), np.arange(g.n))
    h = graphs.relabel(g, order)
    # after node 0, every node with an edge has a neighbour streamed before it
    # unless it starts a new component
    first = np.array([h.indices[h.indptr[v]:h.indptr[v + 1]].min(initial=h.n) for v in range(h.n)])
    starts = np.nonzero((first > np.arange(h.n)) & (np.diff(h.indptr) > 0))[0]
    assert starts[0] == 0 and len(starts) < g.n // 10
