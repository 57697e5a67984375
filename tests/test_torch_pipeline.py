"""repro_torch's pipelined driver and its fused per-record loop against
repro's: labels and StreamStats equal the reference's pipelined driver and
the port's sequential driver at every prefetch and queue depth, on the
host `sparse` and the device `torch` engine (device "cpu"), for every
score and under natural, BFS and hub-first orders; the scalar twins of
RescoreState and ScoreSpec.scalar_fn are bit-identical to the batched
forms; and a failure in T3 reaches the caller with no thread left."""
import dataclasses
import threading

import numpy as np
import pytest

import repro_torch.core.pipeline as port_pipeline
from repro.core.buffcut import BuffCutConfig as RefBuffCutConfig
from repro.core.multilevel import MultilevelConfig as RefMultilevelConfig
from repro.core.pipeline import PipelineConfig as RefPipelineConfig
from repro.core.pipeline import _buffcut_partition_pipelined as ref_pipelined
from repro.core.rescore import RescoreState as RefRescoreState
from repro.core.scores import get_score as ref_get_score
from repro.graphs import apply_order, bfs_order, rmat_graph
from repro_torch.convert import buffcut_config_from_dict, graph_from_numpy
from repro_torch.core import PipelineConfig, buffcut_partition, buffcut_partition_pipelined
from repro_torch.core.rescore import RescoreState
from repro_torch.core.scores import get_score

SCORES = ["anr", "cbs", "haa", "nss", "cms"]


def _port(g):
    return graph_from_numpy(g.indptr, g.indices, g.edge_w, g.node_w)


def _ref_cfg(score="haa", **kw):
    # d_max=24 turns the R-MAT fixture's heaviest nodes into hubs (T3's
    # hub tasks); Q=64, δ=16 gives ~16 batch tasks
    base = dict(k=4, buffer_size=64, batch_size=16, d_max=24, score=score, collect_stats=True,
                ml=RefMultilevelConfig(engine="sparse"))
    base.update(kw)
    return RefBuffCutConfig(**base)


def _port_cfg(ref_cfg, engine="sparse"):
    cfg = buffcut_config_from_dict(ref_cfg.to_dict())
    return dataclasses.replace(cfg, ml=dataclasses.replace(cfg.ml, engine=engine, device="cpu"))


def _orders(g):
    degs = np.diff(g.indptr)
    return {"natural": g, "bfs": apply_order(g, bfs_order(g)),
            "hub_first": apply_order(g, np.argsort(-degs, kind="stable"))}


def _no_pipeline_threads():
    return not [t for t in threading.enumerate()
                if t.name in ("prefetch-pump", "buffcut-t3") and t.is_alive()]


def _assert_same(got, want, *, resident=False):
    block, s = got
    want_block, w = want
    np.testing.assert_array_equal(block, want_block)
    assert (s.cut_weight, s.balance, s.n_batches, s.n_hubs, s.block_loads) == (
        w.cut_weight, w.balance, w.n_batches, w.n_hubs, w.block_loads)
    assert (s.stream_bytes_read, s.io_retries) == (w.stream_bytes_read, w.io_retries)
    if resident:
        assert s.peak_resident_bytes == w.peak_resident_bytes


@pytest.mark.parametrize("queue_depth", [1, 4])
@pytest.mark.parametrize("prefetch", [0, 1, 2, 3])
@pytest.mark.parametrize("engine", ["sparse", "torch"])
def test_pipelined_matches_reference_and_sequential(engine, prefetch, queue_depth, small_rmat):
    ref_cfg = _ref_cfg()
    cfg = _port_cfg(ref_cfg, engine)
    got = buffcut_partition_pipelined(_port(small_rmat), cfg,
                                      PipelineConfig(queue_depth=queue_depth,
                                                     prefetch_batches=prefetch))
    want = ref_pipelined(small_rmat, ref_cfg,
                         RefPipelineConfig(queue_depth=queue_depth, prefetch_batches=prefetch))
    _assert_same(got, want)
    assert got[1].n_hubs > 0 and got[1].n_batches > 1
    assert got[1].ier_per_batch == want[1].ier_per_batch
    # the port's sequential driver (peak residency depends on T3's timing here)
    _assert_same(got, buffcut_partition(_port(small_rmat), cfg))
    assert _no_pipeline_threads()


@pytest.mark.parametrize("score", SCORES)
def test_pipelined_matches_reference_for_every_score(score, small_rmat):
    ref_cfg = _ref_cfg(score)
    got = buffcut_partition_pipelined(_port(small_rmat), _port_cfg(ref_cfg))
    _assert_same(got, ref_pipelined(small_rmat, ref_cfg))
    if score != "cms":  # only the sequential driver keeps CMS's block counts
        _assert_same(got, buffcut_partition(_port(small_rmat), _port_cfg(ref_cfg)))


@pytest.mark.parametrize("order", ["natural", "bfs", "hub_first"])
@pytest.mark.parametrize("score", ["haa", "nss"])
def test_pipelined_matches_reference_under_orders(order, score, small_sbm):
    g = _orders(small_sbm)[order]
    ref_cfg = _ref_cfg(score, d_max=12)
    got = buffcut_partition_pipelined(_port(g), _port_cfg(ref_cfg, "torch"),
                                      PipelineConfig(queue_depth=2, prefetch_batches=1))
    _assert_same(got, ref_pipelined(g, ref_cfg, RefPipelineConfig(queue_depth=2,
                                                                  prefetch_batches=1)))
    _assert_same(got, buffcut_partition(_port(g), _port_cfg(ref_cfg, "sparse")))


def test_pipelined_records_t3_time_and_t2_wait(small_rmat):
    block, stats = buffcut_partition_pipelined(_port(small_rmat), _port_cfg(_ref_cfg()))
    assert 0.0 < stats.ml_time_s < stats.runtime_s
    assert 0.0 <= stats.t3_wait_s < stats.runtime_s


@pytest.mark.parametrize("prefetch", [0, 2])
def test_t3_failure_reaches_the_caller_and_leaves_no_thread(prefetch, small_rmat, monkeypatch):
    calls = []

    def failing_vcycle(*a, **kw):
        calls.append(threading.current_thread().name)
        raise RuntimeError("V-cycle failed in T3")

    monkeypatch.setattr(port_pipeline, "multilevel_partition", failing_vcycle)
    with pytest.raises(RuntimeError, match="failed in T3"):
        buffcut_partition_pipelined(_port(small_rmat), _port_cfg(_ref_cfg()),
                                    PipelineConfig(queue_depth=1, prefetch_batches=prefetch))
    assert calls == ["buffcut-t3"]
    assert _no_pipeline_threads()


def test_pipelined_runs_in_parallel_under_a_short_switch_interval(small_rmat):
    """Eight pipelined runs at once (more threads than cores, each with its
    own T1 and T3) with the interpreter switching threads every
    microsecond: every run gives the sequential driver's labels, and every
    thread is joined."""
    import sys

    cfg = _port_cfg(_ref_cfg())
    want, want_s = buffcut_partition(_port(small_rmat), cfg)
    results: list = [None] * 8

    def run(i):
        results[i] = buffcut_partition_pipelined(
            _port(small_rmat), cfg, PipelineConfig(queue_depth=1 + i % 3,
                                                   prefetch_batches=i % 4))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    for block, stats in results:
        np.testing.assert_array_equal(block, want)
        assert (stats.cut_weight, stats.n_batches, stats.block_loads) == (
            want_s.cut_weight, want_s.n_batches, want_s.block_loads)
    assert _no_pipeline_threads()


def test_pipeline_config_validates_like_the_reference():
    for bad in ({"queue_depth": 0}, {"prefetch_batches": -1}):
        with pytest.raises(ValueError):
            RefPipelineConfig(**bad)
        with pytest.raises(ValueError):
            PipelineConfig(**bad)
    # the reference's knobs, less its superseded record-queue bound
    want = {k: v for k, v in RefPipelineConfig().to_dict().items() if k != "read_ahead"}
    assert dataclasses.asdict(PipelineConfig()) == want


# ---------------------------------------------------- the fused loop's parts

def _records(seed: int, n: int = 64):
    """Stream records (v, nbrs, w, node_w) of a small R-MAT graph with
    fractional weights (sums that round, so the order of adds shows)."""
    g = rmat_graph(n, 4, seed=seed)
    rng = np.random.default_rng(seed + 1)
    out = []
    for v in range(g.n):
        nbrs = g.indices[g.indptr[v]:g.indptr[v + 1]].astype(np.int64)
        w = rng.integers(1, 5, nbrs.size).astype(np.float64) / 3.0
        out.append((v, nbrs, w, 1.0))
    return g.n, out


def _state(st):
    return (st.deg_w, st.assigned_w, st.member,
            st.buffered_w if st.buffered_w is not None else np.zeros(0))


@pytest.mark.parametrize("score", ["anr", "cbs", "haa", "nss"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scalar_twins_match_reference_and_batched(score, seed):
    """Random interleavings of arrival, buffer insert, hub assignment and
    eviction, applied in lockstep to the reference's scalar twins, the
    port's scalar twins and the port's batched bumps: counters bitwise
    equal and the same (node, score) IncreaseKey sequences."""
    n, records = _records(seed)
    rng = np.random.default_rng(seed + 7)
    ref = RefRescoreState(n, ref_get_score(score, d_max=16.0), k=4)
    sc = RescoreState(n, get_score(score, d_max=16.0), k=4)
    bat = RescoreState(n, get_score(score, d_max=16.0), k=4)
    f_ref = ref.spec.scalar_fn()
    f_port = sc.spec.scalar_fn()

    def applied(fn, *args):
        out = []
        fn(*args, lambda x, s: out.append((x, s)))
        return out

    def batched(touched, scores):
        return list(zip(touched.tolist(), scores.tolist()))

    one = lambda v: np.array([v], dtype=np.int64)  # noqa: E731
    for v, nbrs, w, nw in records:
        ref.observe_scalar(v, nbrs, w, nw)
        sc.observe_scalar(v, nbrs, w, nw)
        bat.observe(v, nbrs, w, nw)
        event = rng.integers(0, 3)
        if event == 0:  # v enters the buffer
            want = applied(ref.bump_buffered_scalar, v, f_ref)
            assert applied(sc.bump_buffered_scalar, v, f_port) == want
            if sc.buffered_w is not None:
                assert batched(*bat.bump_buffered(one(v))) == want
            for st in (ref, sc, bat):
                st.member[v] = True
            assert sc.score_scalar(v, f_port) == ref.score_scalar(v, f_ref) == bat.score(v)
        elif event == 1:  # v assigned at once (a hub)
            want = applied(ref.bump_assigned_scalar, v, False, f_ref)
            assert applied(sc.bump_assigned_scalar, v, False, f_port) == want
            assert batched(*bat.bump_assigned(one(v), False)) == want
            ref.adj.drop_one(v)
            sc.adj.drop_one(v)
            bat.release(one(v))
    for v in np.flatnonzero(sc.member).tolist():  # evict every buffered node
        for st in (ref, sc, bat):
            st.member[v] = False
        want = applied(ref.bump_assigned_scalar, v, True, f_ref)
        assert applied(sc.bump_assigned_scalar, v, True, f_port) == want
        assert batched(*bat.bump_assigned(one(v), True)) == want
    for a, b_, c in zip(_state(ref), _state(sc), _state(bat)):
        np.testing.assert_array_equal(a, b_)
        np.testing.assert_array_equal(b_, c)
    assert ref.adj.resident_bytes == sc.adj.resident_bytes == bat.adj.resident_bytes


@pytest.mark.parametrize("beta", [2.0, 0.5, -1.0, 1.7])
@pytest.mark.parametrize("kind", ["anr", "cbs", "haa", "nss", "cms"])
def test_scalar_fn_is_bit_identical_to_call(kind, beta):
    """scalar_fn against the vectorized __call__ and the reference's
    scalar_fn, bit for bit, on degrees around d_max (the pow paths)."""
    rng = np.random.default_rng(abs(int(beta * 10)) + len(kind))
    spec = get_score(kind, d_max=16.0, beta=beta)
    ref_spec = ref_get_score(kind, d_max=16.0, beta=beta)
    # positive degrees: at beta = -1 both closures divide by d / d_max
    d = np.concatenate([rng.integers(1, 40, 200).astype(np.float64),
                        rng.random(200) * 40.0 + 1e-3, [0.5, 1.0, 16.0]])
    a = rng.random(d.size) * d
    q = rng.random(d.size) * 4.0
    cm = rng.random(d.size) * d
    want = spec(a, d, q, cm)
    f, f_ref = spec.scalar_fn(), ref_spec.scalar_fn()
    got = np.array([f(*x) for x in zip(a.tolist(), d.tolist(), q.tolist(), cm.tolist())])
    ref = np.array([f_ref(*x) for x in zip(a.tolist(), d.tolist(), q.tolist(), cm.tolist())])
    assert got.tobytes() == want.tobytes() == ref.tobytes()


def test_rescore_state_shares_a_member_mask():
    member = np.zeros(10, dtype=bool)
    st = RescoreState(10, get_score("haa"), 4, member=member)
    assert st.member is member
    st.observe(3, np.array([1, 2]), np.array([1.0, 1.0]), 1.0)
    assert st.adj.resident_bytes == 2 * 16 + 32
    st.adj.drop_one(3)
    st.adj.drop_one(3)  # a second drop is a no-op, as in the reference
    assert st.adj.resident_bytes == 0
