"""repro_torch's graph substrate against repro's: CSR arrays, padded tiles,
bucketing, generators and the in-memory stream, equal at equal seeds."""
import numpy as np
import pytest

import repro.graphs as rg
import repro.graphs.csr as rcsr
import repro.graphs.stream as rstream
import repro_torch.graphs as tg
import repro_torch.graphs.stream as tstream
from repro_torch.convert import graph_from_numpy

GENERATED = [
    ("rmat_graph", (256, 8), {"seed": 1}),
    ("rmat_graph", (1000, 6), {"seed": 7, "a": 0.45}),
    ("grid_mesh_graph", (24,), {}),
    ("grid_mesh_graph", (9,), {"diag": False}),
    ("sbm_graph", (384, 8), {"p_in": 0.15, "p_out": 0.003, "seed": 3}),
    ("sbm_graph", (200, 4), {"seed": 11}),
]


def _same_csr(a, b):
    for f in ("indptr", "indices", "edge_w", "node_w"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("name,args,kw", GENERATED)
def test_generators_build_identical_arrays(name, args, kw):
    _same_csr(getattr(tg, name)(*args, **kw), getattr(rg, name)(*args, **kw))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_from_edges_dedups_and_orders_like_reference(seed):
    rng = np.random.default_rng(seed)
    n = 50
    edges = rng.integers(0, n, (400, 2))  # self loops and duplicates included
    wts = rng.integers(1, 4, 400).astype(np.float32)
    node_w = rng.integers(1, 3, n).astype(np.float32)
    _same_csr(tg.CSRGraph.from_edges(n, edges, wts, node_w),
              rcsr.CSRGraph.from_edges(n, edges, wts, node_w))


def test_bucket_size_matches_reference():
    for x in list(range(0, 300)) + [1023, 1024, 1025, 65535, 65536, 65537]:
        for minimum in (1, 8, 64):
            assert tg.bucket_size(x, minimum) == rcsr.bucket_size(x, minimum)


def test_padded_tiles_match_reference():
    ref = rg.rmat_graph(100, 4, seed=0)
    g = graph_from_numpy(ref.indptr, ref.indices, ref.edge_w, ref.node_w)
    e_pad = tg.bucket_size(int(g.indices.size), minimum=128)
    for a, b in zip(g.to_coo_padded(128, e_pad), ref.to_coo_padded(128, e_pad)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        g.to_coo_padded(128, int(g.indices.size) - 1)
    nodes = np.array([5, 3, 99, 0, 42])
    for kw in ({}, {"nodes": nodes}, {"nodes": nodes, "row_bucket": 16, "width_bucket": 4}):
        for a, b in zip(g.to_ell_padded(**kw), ref.to_ell_padded(**kw)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(g.slice_indices(nodes), ref.slice_indices(nodes))
    assert g.max_degree == ref.max_degree and g.m == ref.m
    assert g.total_edge_weight() == ref.total_edge_weight()


def test_stream_records_and_totals_match_reference():
    ref = rg.sbm_graph(120, 3, seed=5)
    g = graph_from_numpy(ref.indptr, ref.indices, ref.edge_w, ref.node_w)
    a, b = tg.as_node_stream(g), rstream.as_node_stream(ref)
    assert (a.n, a.m, a.n_total, a.m_total) == (b.n, b.m, b.n_total, b.m_total)
    for ra, rb in zip(a, b):
        assert ra[0] == rb[0] and ra[3] == rb[3]
        np.testing.assert_array_equal(ra[1], rb[1])
        np.testing.assert_array_equal(ra[2], rb[2])
    x = np.random.default_rng(0).random(1001).astype(np.float32)
    assert tstream.seq_sum64(x) == rstream.seq_sum64(x)
    assert tstream.canonical_totals(x, x[:10]) == rstream.canonical_totals(x, x[:10])
    with pytest.raises(TypeError):
        tg.as_node_stream(ref)  # a reference graph is not the port's
