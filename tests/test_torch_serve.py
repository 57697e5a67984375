"""repro_torch's partition service (`repro_torch.serve`) against repro's.

The load-bearing invariant, pinned at every level as in the reference: the
service's resident cut equals `edge_cut` recomputed on the mutated graph,
after any interleaving of updates and refines.  Every service test runs the
port beside a reference service from the same labels and holds labels,
cut, loads and counters equal — exactly (the weights are integers, as the
service's weight caveat asks).  The churn generator and the delta-file
parser give the reference's op lists op for op, and `run_workload` through
a `ServeSession` ends where the reference's does, on the host `sparse`
engine and on the device `torch` engine (device "cpu").  A device error in
a refine reaches the caller and leaves the service refusing later verbs.
"""
from __future__ import annotations

import importlib
import threading

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.graphs as R
from repro.core import BuffCutConfig as RefBuffCutConfig
from repro.core.multilevel import MultilevelConfig as RefMultilevelConfig
from repro.serve import ChurnSpec as RefChurnSpec
from repro.serve import PartitionService as RefPartitionService
from repro.serve import ServeSession as RefServeSession
from repro.serve import churn_ops as ref_churn_ops
from repro.serve import load_delta_file as ref_load_delta_file
from repro.serve import run_workload as ref_run_workload
from repro_torch.convert import graph_from_numpy
from repro_torch.core import BuffCutConfig, IncrementalCut, MultilevelConfig, edge_cut
from repro_torch.graphs import CSRGraph
from repro_torch.serve import (
    ChurnSpec,
    HotAdjacencyCache,
    PartitionService,
    ServeSession,
    churn_ops,
    load_delta_file,
    run_workload,
)

# the function `restream` shadows its module's name on the package
port_restream = importlib.import_module("repro_torch.core.restream")


def _port(g):
    return graph_from_numpy(g.indptr, g.indices, g.edge_w, g.node_w)


def _random_graph(rng: np.random.Generator, n: int, m: int):
    """The same random multigraph in both packages (integer weights)."""
    edges = rng.integers(0, n, size=(m, 2))
    w = rng.integers(1, 4, size=m).astype(np.float32)
    ref = R.CSRGraph.from_edges(n, edges, w)
    return _port(ref), ref


def _cfg(k=4, engine="sparse", **kw):
    return BuffCutConfig(k=k, ml=MultilevelConfig(engine=engine, device="cpu"), **kw)


def _ref_cfg(k=4, **kw):
    return RefBuffCutConfig(k=k, ml=RefMultilevelConfig(engine="sparse"), **kw)


def _pair(g, ref_g, labels, k=4, engine="sparse", cfg_kw=None, **kw):
    """A port service and a reference service from the same labels."""
    cfg_kw = cfg_kw or {"buffer_size": 64, "batch_size": 16}
    return (PartitionService(g, labels, _cfg(k, engine, **cfg_kw), **kw),
            RefPartitionService(ref_g, labels, _ref_cfg(k, **cfg_kw), **kw))


def _assert_same(svc, ref):
    np.testing.assert_array_equal(svc.labels, ref.labels)
    assert svc.cut_weight == ref.cut_weight
    np.testing.assert_array_equal(svc.block_loads, ref.block_loads)
    assert svc.counters == ref.counters
    assert (svc.n, svc.m, svc.buffered) == (ref.n, ref.m, ref.buffered)


def _same_ops(a, b):
    assert len(a) == len(b)
    for (ka, pa), (kb, pb) in zip(a, b):
        assert ka == kb
        if ka == "lookup":
            np.testing.assert_array_equal(pa, pb)
        else:
            assert pa == pb


@pytest.fixture(scope="module")
def grids(small_grid):
    return _port(small_grid), small_grid


# ---------------------------------------------------------------------------
# IncrementalCut.apply_edge_delta — property-pinned against edge_cut
# ---------------------------------------------------------------------------


@given(st.integers(0, 10**6))
@settings(max_examples=25, deadline=None)
def test_apply_edge_delta_matches_recompute(seed):
    """Random insert/delete/duplicate/self-loop sequences: the maintained
    cut equals edge_cut on the graph rebuilt from the mutated edge set."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(8, 48))
    g, _ = _random_graph(rng, n, int(rng.integers(n, 4 * n)))
    block = rng.integers(0, 3, size=n).astype(np.int64)
    cm = IncrementalCut(edge_cut(g, block))
    mirror: dict = {}
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(g.indptr))
    for u, v, w in zip(src.tolist(), g.indices.tolist(),
                       g.edge_w.astype(np.float64).tolist()):
        if u < v:
            mirror[(u, v)] = w
    for _ in range(60):
        op = rng.random()
        if op < 0.15:  # self-loop insert: never cut, never stored
            u = int(rng.integers(n))
            assert cm.apply_edge_delta(u, u, 5.0, block) == 0.0
        elif op < 0.45 and mirror:  # delete an existing edge entirely
            keys = sorted(mirror)
            e = keys[int(rng.integers(len(keys)))]
            cm.apply_edge_delta(e[0], e[1], -mirror.pop(e), block)
        else:  # insert — fresh pair or duplicate (weight accumulates)
            u, v = int(rng.integers(n)), int(rng.integers(n))
            if u == v:
                continue
            e = (min(u, v), max(u, v))
            w = float(rng.integers(1, 4))
            cm.apply_edge_delta(u, v, w, block)
            mirror[e] = mirror.get(e, 0.0) + w
    if mirror:
        edges = np.asarray(sorted(mirror), dtype=np.int64)
        weights = np.asarray([mirror[tuple(e)] for e in edges.tolist()],
                             dtype=np.float32)
    else:
        edges = np.empty((0, 2), dtype=np.int64)
        weights = np.empty(0, dtype=np.float32)
    g2 = CSRGraph.from_edges(n, edges, weights)
    assert cm.cut_weight == edge_cut(g2, block)


def test_apply_edge_delta_refused_mid_bracket():
    g = CSRGraph.from_edges(4, np.array([[0, 1], [1, 2], [2, 3]]))
    block = np.array([0, 0, 1, 1], dtype=np.int64)
    cm = IncrementalCut(edge_cut(g, block))
    bnodes = np.array([1], dtype=np.int64)
    nbr = g.neighbors(1).astype(np.int64)
    w = g.neighbor_weights(1).astype(np.float64)
    degs = np.array([nbr.shape[0]], dtype=np.int64)
    cm.stage(bnodes, degs, nbr, w, block)
    with pytest.raises(RuntimeError, match="batch boundaries"):
        cm.apply_edge_delta(0, 3, 1.0, block)
    cm.commit(bnodes, block[bnodes], degs, nbr, w, block)
    assert cm.apply_edge_delta(0, 3, 1.0, block) == 1.0


def test_apply_edge_delta_unassigned_endpoint():
    """-1 endpoints count as cut only against assigned nodes, exactly
    edge_cut's `block[src] != block[dst]`."""
    block = np.array([0, -1, -1], dtype=np.int64)
    cm = IncrementalCut(0.0)
    assert cm.apply_edge_delta(0, 1, 2.0, block) == 2.0
    g = CSRGraph.from_edges(3, np.array([[0, 1]]), np.array([2.0], dtype=np.float32))
    assert cm.cut_weight == edge_cut(g, block)


# ---------------------------------------------------------------------------
# PartitionService — exactness, determinism, delta semantics
# ---------------------------------------------------------------------------


@given(st.integers(0, 10**6))
@settings(max_examples=10, deadline=None)
def test_service_exact_under_update_refine_interleaving(seed):
    """Updates interleaved with refines keep the resident cut exactly equal
    to a recompute at every quiescent point, and every step equal to the
    reference's."""
    rng = np.random.default_rng(seed)
    g, ref_g = _random_graph(rng, 64, 160)
    labels = rng.integers(0, 4, size=g.n).astype(np.int64)
    svc, ref = _pair(g, ref_g, labels)
    spec = dict(updates=10, ops=8, frac_del=0.3, node_adds=2, lookup_every=0,
                refine_every=3, seed=seed)
    ops = churn_ops(g, ChurnSpec(**spec))
    _same_ops(ops, ref_churn_ops(ref_g, RefChurnSpec(**spec)))
    for kind, payload in ops:
        if kind == "update":
            svc.update(**payload)
            ref.update(**payload)
        elif kind == "refine":
            out = svc.refine(payload)
            want = ref.refine(payload)
            want.pop("engine_fallbacks")
            assert out == want
        assert svc.cut_weight == edge_cut(svc.export_graph(), svc.labels)
        _assert_same(svc, ref)
    gg = svc.export_graph()
    assert gg.m == svc.m
    loads = np.zeros(svc.k, dtype=np.float64)
    np.add.at(loads, svc.labels, gg.node_w.astype(np.float64))
    np.testing.assert_allclose(loads, svc.block_loads, rtol=0, atol=1e-9)


@pytest.mark.parametrize("engine", ["sparse", "torch"])
def test_service_determinism_same_stream_twice(engine, grids):
    g, ref_g = grids
    rng = np.random.default_rng(5)
    labels = rng.integers(0, 4, size=g.n).astype(np.int64)
    kw = {"buffer_size": 128, "batch_size": 32}
    spec = dict(updates=16, ops=12, frac_del=0.25, node_adds=4, refine_every=4, seed=11)
    outs = []
    for _ in range(2):
        svc = PartitionService(g, labels, _cfg(engine=engine, **kw))
        run_workload(svc, churn_ops(g, ChurnSpec(**spec)))
        svc.refine()
        outs.append(svc.labels)
    ref = RefPartitionService(ref_g, labels, _ref_cfg(**kw))
    ref_run_workload(ref, ref_churn_ops(ref_g, RefChurnSpec(**spec)))
    ref.refine()
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], ref.labels)


def _tiny(edges, labels, k=2):
    g = CSRGraph.from_edges(len(labels), np.asarray(edges))
    ref_g = R.CSRGraph.from_edges(len(labels), np.asarray(edges))
    return _pair(g, ref_g, np.asarray(labels), k=k, cfg_kw={})


def test_duplicate_insert_accumulates_weight():
    svc, ref = _tiny([[0, 1], [2, 3]], [0, 1, 0, 1])
    m0, cut0 = svc.m, svc.cut_weight
    for s in (svc, ref):
        s1 = s.update(insert_edges=[(0, 1, 2.0)])
        s2 = s.update(insert_edges=[(1, 0, 3.0)])
        assert s1["duplicate_merges"] == 1 and s2["duplicate_merges"] == 1
    assert svc.m == m0
    assert svc.cut_weight == cut0 + 5.0
    gg = svc.export_graph()
    assert svc.cut_weight == edge_cut(gg, svc.labels)
    nbrs = gg.neighbors(0)
    assert gg.neighbor_weights(0)[nbrs == 1][0] == 6.0  # 1 + 2 + 3
    _assert_same(svc, ref)


def test_self_loop_insert_ignored_but_counted():
    svc, ref = _tiny([[0, 1], [1, 2]], [0, 1, 0])
    m0, cut0 = svc.m, svc.cut_weight
    s = svc.update(insert_edges=[(1, 1, 9.0)])
    ref.update(insert_edges=[(1, 1, 9.0)])
    assert s["self_loops_ignored"] == 1
    assert svc.m == m0 and svc.cut_weight == cut0
    assert svc.cut_weight == edge_cut(svc.export_graph(), svc.labels)
    _assert_same(svc, ref)


def test_node_adds_assigned_and_attached():
    svc, ref = _tiny([[0, 1], [2, 3]], [0, 0, 1, 1])
    s = svc.update(add_nodes=2, insert_edges=[(4, 0), (5, 4)])
    ref.update(add_nodes=2, insert_edges=[(4, 0), (5, 4)])
    assert s["nodes_added"] == [4, 5]
    assert svc.n == 6
    lbl = svc.lookup([4, 5])
    np.testing.assert_array_equal(lbl, ref.lookup([4, 5]))
    assert ((0 <= lbl) & (lbl < 2)).all()
    assert svc.cut_weight == edge_cut(svc.export_graph(), svc.labels)
    _assert_same(svc, ref)


def test_update_error_semantics():
    svc, _ = _tiny([[0, 1], [2, 3]], [0, 0, 1, 1])
    with pytest.raises(ValueError, match="no such edge"):
        svc.update(delete_edges=[(0, 2)])
    with pytest.raises(ValueError, match="self-loop"):
        svc.update(delete_edges=[(1, 1)])
    with pytest.raises(ValueError, match="add nodes first"):
        svc.update(insert_edges=[(0, 7)])
    with pytest.raises(ValueError, match="must be > 0"):
        svc.update(insert_edges=[(0, 2, -1.0)])
    with pytest.raises(ValueError, match=r"nodes \[0, 4\)"):
        svc.lookup([4])
    assert svc.cut_weight == edge_cut(svc.export_graph(), svc.labels)


def test_construction_validates():
    g = CSRGraph.from_edges(3, np.array([[0, 1], [1, 2]]))
    with pytest.raises(ValueError, match="complete assignment"):
        PartitionService(g, np.array([0, -1, 1]), _cfg(k=2))
    with pytest.raises(ValueError, match="3 nodes"):
        PartitionService(g, np.array([0, 1]), _cfg(k=2))
    with pytest.raises(ValueError, match="buffer_cap"):
        PartitionService(g, np.array([0, 1, 1]), _cfg(k=2), buffer_cap=0)


def test_buffer_bounded_and_refine_budget():
    rng = np.random.default_rng(2)
    g, ref_g = _random_graph(rng, 64, 200)
    labels = rng.integers(0, 4, size=g.n).astype(np.int64)
    svc, ref = _pair(g, ref_g, labels, buffer_cap=8)
    spec = ChurnSpec(updates=6, ops=10, frac_del=0.2, lookup_every=0, refine_every=0, seed=4)
    for kind, payload in churn_ops(g, spec):
        if kind == "update":
            svc.update(**payload)
            ref.update(**payload)
    assert 0 < svc.buffered <= 8
    before = svc.buffered
    out = svc.refine(budget=3)
    ref.refine(budget=3)
    assert out["redecided"] == 3 and svc.buffered == before - 3
    svc.refine()
    ref.refine()
    assert svc.buffered == 0
    assert svc.cut_weight == edge_cut(svc.export_graph(), svc.labels)
    _assert_same(svc, ref)


def test_hot_cache_lru_bounded():
    cache = HotAdjacencyCache(budget_bytes=600)
    for v in range(20):
        cache.put(v, np.arange(8, dtype=np.int64), np.ones(8, dtype=np.float64), 1.0)
    assert cache.resident_bytes <= 600
    assert len(cache) < 20
    assert cache.get(19) is not None  # most recent row survives
    cache.invalidate(19)
    assert cache.get(19) is None
    with pytest.raises(ValueError, match="budget"):
        HotAdjacencyCache(-1)


def test_service_stats_shape(grids):
    g, ref_g = grids
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 4, size=g.n).astype(np.int64)
    svc, ref = _pair(g, ref_g, labels)
    for s in (svc, ref):
        s.update(insert_edges=[(0, 5)])
        s.refine()
    st_ = svc.stats()
    assert st_ == ref.stats()
    for key in ("n", "m", "k", "cut_weight", "balance", "buffered",
                "overlay_rows", "cache_resident_bytes", "counters"):
        assert key in st_
    assert st_["counters"]["updates"] == 1
    assert st_["counters"]["refines"] == 1


def test_refine_device_error_reaches_the_caller(grids, monkeypatch):
    """No host fallback: a V-cycle error in a refine propagates, and the
    service then refuses every verb (the failed batch stays detached)."""
    g, _ = grids
    labels = np.random.default_rng(8).integers(0, 4, size=g.n).astype(np.int64)
    svc = PartitionService(g, labels, _cfg(engine="torch", buffer_size=64, batch_size=16))
    svc.update(insert_edges=[(0, 5), (1, 7)])

    def lost_card(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(port_restream, "multilevel_partition", lost_card)
    with ServeSession(svc) as sess:
        with pytest.raises(RuntimeError, match="illegal memory access"):
            sess.refine()
        with pytest.raises(RuntimeError, match="unusable") as err:
            sess.lookup([0])
        assert "illegal memory access" in str(err.value.__cause__)
    for verb in (lambda: svc.update(insert_edges=[(2, 9)]), svc.refine):
        with pytest.raises(RuntimeError, match="unusable"):
            verb()


# ---------------------------------------------------------------------------
# ServeSession — lifecycle, coalescing, error routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["sparse", "torch"])
def test_session_matches_direct_service_and_reference(engine, grids):
    g, ref_g = grids
    rng = np.random.default_rng(9)
    labels = rng.integers(0, 4, size=g.n).astype(np.int64)
    spec = dict(updates=8, ops=8, refine_every=4, seed=2)
    direct, ref = _pair(g, ref_g, labels, engine=engine)
    run_workload(direct, churn_ops(g, ChurnSpec(**spec)))
    svc = PartitionService(g, labels, _cfg(engine=engine, buffer_size=64, batch_size=16))
    with ServeSession(svc) as sess:
        run_workload(sess, churn_ops(g, ChurnSpec(**spec)))
    with RefServeSession(ref) as rsess:
        ref_run_workload(rsess, ref_churn_ops(ref_g, RefChurnSpec(**spec)))
    np.testing.assert_array_equal(direct.labels, svc.labels)
    assert direct.cut_weight == svc.cut_weight
    _assert_same(svc, ref)


def _gated(svc):
    gate = threading.Event()
    orig_update = svc.update

    def slow_update(**kw):
        gate.wait(timeout=5.0)
        return orig_update(**kw)

    svc.update = slow_update
    return gate


def test_session_coalesces_queued_lookups(grids):
    g, ref_g = grids
    labels = np.random.default_rng(3).integers(0, 4, size=g.n).astype(np.int64)
    svc, _ = _pair(g, ref_g, labels)
    gate = _gated(svc)
    with ServeSession(svc) as sess:
        blocker = sess.submit_update(insert_edges=[(0, 9)])
        futs = [sess.submit_lookup([i, i + 1]) for i in range(5)]
        gate.set()
        blocker.result(timeout=5.0)
        for i, f in enumerate(futs):
            np.testing.assert_array_equal(f.result(timeout=5.0), svc.lookup([i, i + 1]))
        assert sess.stats["coalesced_lookups"] == 4
        assert sess.stats["lookups"] == 5


def test_session_coalesced_error_lands_on_offender(grids):
    g, ref_g = grids
    labels = np.random.default_rng(3).integers(0, 4, size=g.n).astype(np.int64)
    svc, _ = _pair(g, ref_g, labels)
    gate = _gated(svc)
    with ServeSession(svc) as sess:
        blocker = sess.submit_update(insert_edges=[(0, 9)])
        good = sess.submit_lookup([0, 1])
        bad = sess.submit_lookup([10**7])  # out of range
        good2 = sess.submit_lookup([2])
        gate.set()
        blocker.result(timeout=5.0)
        assert good.result(timeout=5.0).shape == (2,)
        with pytest.raises(ValueError, match="lookup references node"):
            bad.result(timeout=5.0)
        assert good2.result(timeout=5.0).shape == (1,)
        assert sess.lookup([3]).shape == (1,)


def test_session_request_error_keeps_serving(grids):
    g, ref_g = grids
    labels = np.random.default_rng(4).integers(0, 4, size=g.n).astype(np.int64)
    svc, _ = _pair(g, ref_g, labels)
    with ServeSession(svc) as sess:
        with pytest.raises(ValueError, match="no such edge"):
            sess.update(delete_edges=[(0, 3)])
        assert sess.lookup([0]).shape == (1,)


def test_session_close_idempotent_then_refuses(grids):
    g, ref_g = grids
    labels = np.random.default_rng(6).integers(0, 4, size=g.n).astype(np.int64)
    svc, _ = _pair(g, ref_g, labels)
    sess = ServeSession(svc)
    assert sess.lookup([1]).shape == (1,)
    sess.close()
    sess.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        sess.lookup([1])
    assert not [t for t in threading.enumerate() if t.name == "serve-worker" and t.is_alive()]


# ---------------------------------------------------------------------------
# workloads: churn ops, delta files, replay
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    "churn:updates=9,ops=3,frac_del=0.5,seed=7",
    "churn:updates=24,ops=16,frac_del=0.25,node_adds=6,lookup_every=2,lookup_size=32,"
    "refine_every=5,refine_budget=7,seed=3",
    "churn:updates=12,ops=40,frac_del=1.0,refine_every=0,seed=1",
    "gen:churn:",
])
def test_churn_ops_match_reference(spec, grids):
    g, ref_g = grids
    ours, theirs = ChurnSpec.parse(spec), RefChurnSpec.parse(spec)
    assert ours.__dict__ == theirs.__dict__
    _same_ops(churn_ops(g, ours), ref_churn_ops(ref_g, theirs))


def test_churn_spec_parse():
    spec = ChurnSpec.parse("gen:churn:updates=9,ops=3,frac_del=0.5,seed=7")
    assert (spec.updates, spec.ops, spec.frac_del, spec.seed) == (9, 3, 0.5, 7)
    assert ChurnSpec.parse("churn:").updates == ChurnSpec().updates
    with pytest.raises(ValueError, match="unknown churn spec field"):
        ChurnSpec.parse("churn:bogus=1")
    with pytest.raises(ValueError, match="key=value"):
        ChurnSpec.parse("churn:updates")
    with pytest.raises(ValueError, match="frac_del"):
        ChurnSpec(frac_del=1.5)


_DELTAS = (
    "# comment\n"
    "add 0 5\n"
    "+ 1 6 2.0\n"
    "node\n"
    "del 0 1\n"
    "lookup 0 1 2\n"
    "- 2 3\n"
    "refine 4\n"
    "? 5\n"
    "!\n"
)


def test_delta_file_parse_and_grouping(tmp_path):
    p = tmp_path / "deltas.txt"
    p.write_text(_DELTAS)
    ops = load_delta_file(str(p))
    _same_ops(ops, ref_load_delta_file(str(p)))
    kinds = [k for k, _ in ops]
    assert kinds == ["update", "lookup", "update", "refine", "lookup", "refine"]
    first = ops[0][1]
    assert first["insert_edges"] == [(0, 5, 1.0), (1, 6, 2.0)]
    assert first["add_nodes"] == [1.0]
    assert first["delete_edges"] == [(0, 1)]
    assert ops[3][1] == 4 and ops[5][1] is None


@pytest.mark.parametrize("bad,why", [
    ("add 0 1\nwat 3\n", r"bad\.txt:2.*unknown op"),
    ("add 0\n", r"bad\.txt:1.*add u v"),
    ("refine 1 2\n", r"bad\.txt:1.*refine \[budget\]"),
    ("lookup\n", r"bad\.txt:1.*lookup u1"),
])
def test_delta_file_parse_error_has_line_number(bad, why, tmp_path):
    p = tmp_path / "bad.txt"
    p.write_text(bad)
    with pytest.raises(ValueError, match=why):
        load_delta_file(str(p))
    with pytest.raises(ValueError, match=why):
        ref_load_delta_file(str(p))


@pytest.mark.parametrize("engine", ["sparse", "torch"])
def test_run_workload_matches_reference(engine, grids, tmp_path):
    """A churn workload and a delta file through a session: labels, cut,
    loads, counters and the lookup checksum equal the reference's."""
    g, ref_g = grids
    labels = np.random.default_rng(12).integers(0, 4, size=g.n).astype(np.int64)
    spec = dict(updates=20, ops=10, frac_del=0.3, node_adds=3, lookup_every=3,
                lookup_size=64, refine_every=5, seed=21)
    svc, ref = _pair(g, ref_g, labels, engine=engine)
    with ServeSession(svc) as sess:
        out = run_workload(sess, churn_ops(g, ChurnSpec(**spec)))
    want = ref_run_workload(ref, ref_churn_ops(ref_g, RefChurnSpec(**spec)))
    assert out["lookup_checksum"] == want["lookup_checksum"]
    for verb in ("lookup", "update", "refine"):
        assert out[verb]["count"] == want[verb]["count"]
    assert out["update"]["edge_ops"] == want["update"]["edge_ops"]
    assert out["lookup"]["nodes"] == want["lookup"]["nodes"]
    _assert_same(svc, ref)
    assert svc.cut_weight == edge_cut(svc.export_graph(), svc.labels)
    p = tmp_path / "d.txt"
    p.write_text("add 0 37\nadd 1 38\nnode\nlookup 0 1 2 3\ndel 0 37\n+ 2 40 2.0\nrefine\n"
                 "? 5 6\n!\n")
    out = run_workload(svc, load_delta_file(str(p)))
    want = ref_run_workload(ref, ref_load_delta_file(str(p)))
    assert out["lookup_checksum"] == want["lookup_checksum"]
    _assert_same(svc, ref)
    with pytest.raises(ValueError, match="unknown workload verb"):
        run_workload(svc, [("bogus", None)])


# ---------------------------------------------------------------------------
# the front door: into_service, capability flags, the serve CLIs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["sparse", "torch"])
def test_into_service_roundtrip_and_exactness(engine, grids):
    from repro.api import partition as ref_partition
    from repro_torch.api import partition

    g, ref_g = grids
    kw = dict(driver="buffcut", k=4, buffer_size=128, batch_size=32)
    res = partition(g, engine=engine, device="cpu", **kw)
    svc = res.into_service(buffer_cap=32)
    ref_svc = ref_partition(ref_g, engine="sparse", **kw).into_service(buffer_cap=32)
    assert svc.buffer_cap == 32
    assert svc.cut_weight == res.cut_weight == ref_svc.cut_weight
    assert svc.cut_weight == edge_cut(g, res.labels)
    for s_ in (svc, ref_svc):
        s_.update(insert_edges=[(0, g.n - 1)])
        s_.refine()
    assert svc.cut_weight == edge_cut(svc.export_graph(), svc.labels) == ref_svc.cut_weight
    np.testing.assert_array_equal(svc.labels, ref_svc.labels)


def test_into_service_capability_gate(grids):
    from repro_torch.api import partition

    res = partition(grids[0], driver="fennel", k=4, device="cpu")
    with pytest.raises(ValueError, match="dynamic-capable drivers"):
        res.into_service()


def test_into_service_reresolves_from_provenance():
    from repro_torch.api import PartitionResult, partition

    res = partition("gen:grid:side=12", driver="buffcut", k=4, device="cpu")
    res2 = PartitionResult.from_json(res.to_json())
    assert res2.graph is None
    svc = res2.into_service()
    assert svc.n == 144
    assert svc.cut_weight == edge_cut(svc.export_graph(), svc.labels)
    del res2.provenance["source"]["origin"]
    with pytest.raises(ValueError, match="pass source= explicitly"):
        res2.into_service()
    assert res2.into_service(source="gen:grid:side=12").n == 144


def test_registry_capability_flags():
    from repro.api import get_partitioner as ref_get
    from repro.api import list_partitioners as ref_list
    from repro_torch.api import get_partitioner

    caps = get_partitioner("buffcut").capabilities()
    assert caps == {"disk_stream": True, "checkpoint": True, "shard": True, "dynamic": True}
    assert get_partitioner("fennel").capabilities()["dynamic"] is False
    assert "supports_dynamic=True" in repr(get_partitioner("buffcut"))
    for name in ref_list():
        assert get_partitioner(name).capabilities() == ref_get(name).capabilities()
        assert get_partitioner(name).aliases == ref_get(name).aliases


def test_cli_serve_churn(tmp_path):
    import json

    from repro.api.cli import main as ref_main
    from repro_torch.api.cli import main

    args = ["serve", "gen:grid:side=16", "-k", "4",
            "--workload", "gen:churn:updates=8,ops=6,node_adds=2,refine_every=4,seed=1"]
    out, ref_out = tmp_path / "serve.json", tmp_path / "ref.json"
    assert main([*args, "--device", "cpu", "--json", str(out)]) == 0
    assert ref_main([*args, "--json", str(ref_out)]) == 0
    report, want = json.loads(out.read_text()), json.loads(ref_out.read_text())
    assert report["exact"]["match"] is True
    assert report["workload"]["update"]["count"] == 8
    assert report["workload"]["lookup"]["p99_ms"] >= 0.0
    assert report["provenance"]["driver"] == "buffcut"
    assert report["session"]["requests"] == report["provenance"]["ops"]
    assert report["exact"] == want["exact"]
    assert report["provenance"]["initial_cut"] == want["provenance"]["initial_cut"]
    assert report["workload"]["lookup_checksum"] == want["workload"]["lookup_checksum"]


def test_cli_serve_delta_file(tmp_path):
    from repro_torch.api.cli import main

    p = tmp_path / "d.txt"
    p.write_text("add 0 37\nadd 1 38\ndel 0 1\nlookup 0 1 2 3\nrefine\n")
    rc = main(["serve", "gen:grid:side=8", "-k", "2", "--device", "cpu",
               "--delta-file", str(p), "--json", str(tmp_path / "r.json")])
    assert rc == 0


def test_cli_serve_rejects_incapable_driver(capsys):
    from repro_torch.api.cli import main

    rc = main(["serve", "gen:grid:side=8", "-k", "2", "--driver", "ldg", "--device", "cpu"])
    assert rc == 1
    assert "dynamic-capable drivers" in capsys.readouterr().err


def test_cli_serve_without_a_card_fails(capsys, monkeypatch):
    import torch

    import repro_torch.api as api_mod
    from repro_torch.api.cli import main

    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card error path cannot be shown")
    resolved = []
    real_resolve = api_mod.resolve_source
    monkeypatch.setattr(api_mod, "resolve_source",
                        lambda s: resolved.append(s) or real_resolve(s))
    assert main(["serve", "gen:grid:side=8", "-k", "2"]) == 1
    # refused before the source is read
    assert resolved == [] and "no CUDA device" in capsys.readouterr().err


def test_serve_arch_partition_cli(capsys):
    """`python -m repro_torch.launch.serve --arch partition`: one API call,
    the result promoted into a service, lookups checked against it."""
    from repro_torch.launch import serve

    serve.main(["--arch", "partition", "--device", "cpu", "--graph", "gen:grid:side=16",
                "--k", "4", "--batch", "8", "--queries", "5"])
    out = capsys.readouterr().out
    assert out.startswith("partition serve: driver=buffcut device=cpu n=256 k=4 ")
    assert "5 batches x 8 lookups" in out
