"""repro_torch's vectorized driver, its VectorBuffer and score_kernel
against repro's: labels, evictions and StreamStats (peak residency
included) equal the reference's vectorized driver at wave/chunk 1/1 and
16/32 on both buffer engines; wave 1 reproduces the port's sequential
driver (the reference's driver-equivalence property); VectorBuffer's
waves equal the reference's and BucketPQ's; score_kernel equals the
reference's jitted kernel in float64."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.buffcut import BuffCutConfig as RefBuffCutConfig
from repro.core.buffer import BucketPQ as RefBucketPQ
from repro.core.buffer import VectorBuffer as RefVectorBuffer
from repro.core.multilevel import MultilevelConfig as RefMultilevelConfig
from repro.core.vector_stream import VectorizedConfig as RefVectorizedConfig
from repro.core.vector_stream import _buffcut_partition_vectorized as ref_vectorized
from repro.core.vector_stream import score_kernel as ref_score_kernel
from repro.graphs import apply_order, bfs_order, random_order, rmat_graph
from repro_torch.convert import buffcut_config_from_dict, graph_from_numpy
from repro_torch.core import (
    VectorizedConfig,
    buffcut_partition,
    buffcut_partition_vectorized,
    score_kernel,
)
from repro_torch.core.buffer import BucketPQ, VectorBuffer
from repro_torch.core.metrics import edge_cut
from repro_torch.core.scores import get_score


def _port(g):
    return graph_from_numpy(g.indptr, g.indices, g.edge_w, g.node_w)


def _ref_cfg(g, score="haa", engine="sparse", **kw):
    # the reference's driver-equivalence sizes: Q = n/8, δ = n/16, d_max = n/8
    base = dict(k=4, buffer_size=max(g.n // 8, 16), batch_size=max(g.n // 16, 8),
                d_max=max(g.n / 8, 32), score=score, collect_stats=True,
                ml=RefMultilevelConfig(engine=engine))
    base.update(kw)
    return RefBuffCutConfig(**base)


def _port_cfg(ref_cfg, engine="sparse"):
    cfg = buffcut_config_from_dict(ref_cfg.to_dict())
    return dataclasses.replace(cfg, ml=dataclasses.replace(cfg.ml, engine=engine, device="cpu"))


def _orders(g):
    degs = np.diff(g.indptr)
    return {"natural": g, "bfs": apply_order(g, bfs_order(g)),
            # hubs first: the order buffered streaming exists to survive
            "adversarial": apply_order(g, np.argsort(-degs, kind="stable"))}


def _assert_same(got, want, *, resident=True):
    block, s = got
    want_block, w = want
    np.testing.assert_array_equal(block, want_block)
    assert [int(x) for x in s.evictions] == [int(x) for x in w.evictions]
    assert (s.cut_weight, s.balance, s.n_batches, s.n_hubs, s.block_loads,
            s.ier_per_batch) == (
        w.cut_weight, w.balance, w.n_batches, w.n_hubs, w.block_loads, w.ier_per_batch)
    if resident:
        assert s.peak_resident_bytes == w.peak_resident_bytes


@pytest.mark.parametrize("buffer_engine", ["incremental", "scan"])
@pytest.mark.parametrize("wave,chunk", [(1, 1), (16, 32)])
@pytest.mark.parametrize("score", ["anr", "cbs", "haa", "nss"])
def test_vectorized_matches_reference(score, wave, chunk, buffer_engine, small_sbm):
    g = small_sbm
    ref_cfg = _ref_cfg(g, score, k=8, d_max=12)
    vec = dict(wave=wave, chunk=chunk, engine=buffer_engine)
    got = buffcut_partition_vectorized(_port(g), _port_cfg(ref_cfg), VectorizedConfig(**vec))
    want = ref_vectorized(g, ref_cfg, RefVectorizedConfig(**vec))
    _assert_same(got, want)
    assert got[1].n_hubs > 0


@pytest.mark.parametrize("wave,chunk", [(1, 1), (16, 32)])
@pytest.mark.parametrize("order", ["natural", "bfs", "adversarial"])
def test_vectorized_matches_reference_on_the_device_engine(order, wave, chunk, small_rmat):
    g = _orders(small_rmat)[order]
    ref_cfg = _ref_cfg(g)
    got = buffcut_partition_vectorized(_port(g), _port_cfg(ref_cfg, "torch"),
                                       VectorizedConfig(wave=wave, chunk=chunk),
                                       prefetch_batches=2)
    # prefetch staging makes peak residency depend on the pump's timing
    _assert_same(got, ref_vectorized(g, ref_cfg, RefVectorizedConfig(wave=wave, chunk=chunk)),
                 resident=False)


def _assert_equivalent(g, ref_cfg, buffer_engine):
    """wave = chunk = 1 reproduces the port's sequential driver: same
    eviction order, same labels and cut."""
    cfg = _port_cfg(ref_cfg)
    b_seq, s_seq = buffcut_partition(_port(g), cfg)
    b_vec, s_vec = buffcut_partition_vectorized(
        _port(g), cfg, VectorizedConfig(wave=1, chunk=1, engine=buffer_engine))
    assert s_seq.evictions == [int(x) for x in s_vec.evictions]
    np.testing.assert_array_equal(b_seq, b_vec)
    assert s_seq.cut_weight == s_vec.cut_weight == edge_cut(_port(g), b_vec)


@pytest.mark.parametrize("buffer_engine", ["incremental", "scan"])
@pytest.mark.parametrize("order", ["natural", "bfs", "adversarial"])
def test_wave1_reproduces_sequential(buffer_engine, order, small_rmat):
    g = _orders(small_rmat)[order]
    _assert_equivalent(g, _ref_cfg(g), buffer_engine)


@pytest.mark.parametrize("score", ["anr", "cbs", "haa", "nss"])
def test_wave1_all_scores(score, random_grid):
    _assert_equivalent(random_grid, _ref_cfg(random_grid, score), "incremental")


@given(st.integers(0, 10**6), st.integers(0, 2))
@settings(max_examples=8, deadline=None)
def test_wave1_equivalence_property(seed, order_idx):
    """Random graphs x random orders x both engines, exact equivalence."""
    g0 = rmat_graph(192, 5, seed=seed % 101)
    g = list(_orders(apply_order(g0, random_order(g0, seed % 13))).values())[order_idx]
    cfg = _ref_cfg(g, "haa" if seed % 2 else "nss")
    for buffer_engine in ("incremental", "scan"):
        _assert_equivalent(g, cfg, buffer_engine)


def test_cms_is_refused_like_the_reference(small_rmat):
    ref_cfg = _ref_cfg(small_rmat, "cms")
    with pytest.raises(ValueError, match="CMS"):
        ref_vectorized(small_rmat, ref_cfg)
    with pytest.raises(ValueError, match="CMS"):
        buffcut_partition_vectorized(_port(small_rmat), _port_cfg(ref_cfg))


def test_vectorized_config_validates_like_the_reference():
    for bad in ({"wave": 0}, {"chunk": 0}, {"engine": "heap"}):
        with pytest.raises(ValueError):
            RefVectorizedConfig(**bad)
        with pytest.raises(ValueError):
            VectorizedConfig(**bad)
    assert dataclasses.asdict(VectorizedConfig()) == RefVectorizedConfig().to_dict()
    with pytest.raises(ValueError):
        VectorBuffer(4, 1.0, 100, engine="heap")


@pytest.mark.parametrize("kind", ["anr", "cbs", "haa", "nss"])
def test_score_kernel_matches_reference_in_float64(kind):
    rng = np.random.default_rng(len(kind))
    a = rng.random(500) * 8
    d = rng.integers(0, 20, 500).astype(np.float64)
    q = rng.random(500) * 4
    spec = get_score(kind, d_max=100.0)
    kw = dict(kind=kind, d_max=100.0, beta=spec.beta, theta=spec.theta, eta=spec.eta)
    with jax.enable_x64(True):
        want = np.asarray(ref_score_kernel(jnp.asarray(a), jnp.asarray(d), jnp.asarray(q), **kw))
    assert want.dtype == np.float64
    got = score_kernel(torch.from_numpy(a), torch.from_numpy(d), torch.from_numpy(q), **kw)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)
    np.testing.assert_allclose(got.numpy(), spec(a, d, q), rtol=1e-12, atol=0)
    with pytest.raises(ValueError):
        score_kernel(torch.from_numpy(a), torch.from_numpy(d), torch.from_numpy(q), kind="cms")


# ------------------------------------------------------------- VectorBuffer

@st.composite
def op_sequences(draw):
    """Random insert / increase_key / extract traces with monotone keys
    (the reference's test_buffer.py strategy)."""
    ops = []
    alive: dict[int, float] = {}
    next_id = 0
    for _ in range(draw(st.integers(5, 60))):
        choice = draw(st.integers(0, 2))
        if choice == 0 or not alive:
            s = draw(st.floats(0, 1, allow_nan=False))
            ops.append(("insert", next_id, s))
            alive[next_id] = s
            next_id += 1
        elif choice == 1:
            v = draw(st.sampled_from(sorted(alive)))
            s = min(alive[v] + draw(st.floats(0, 0.5, allow_nan=False)), 1.0)
            ops.append(("increase", v, s))
            alive[v] = s
        else:
            ops.append(("extract", None, None))
    return ops


def _check_invariants(vb: VectorBuffer) -> None:
    """Occupancy counts match live keys, the compact arrays mirror the
    dense vectors, rho bounds the top bucket."""
    live = np.nonzero(vb.in_buf)[0]
    assert live.size == len(vb) == vb._size
    occ = np.bincount(vb.key[live], minlength=vb.n_buckets)
    assert np.array_equal(occ, vb._bucket_count[: vb.n_buckets])
    if live.size:
        assert vb._rho >= int(vb.key[live].max())
    act = vb._active[: vb._size]
    assert sorted(act.tolist()) == sorted(live.tolist())
    assert np.array_equal(vb._pos[act], np.arange(vb._size))
    assert np.array_equal(vb._akey[: vb._size], vb.key[act])
    assert np.array_equal(vb._astamp[: vb._size], vb.stamp[act])


@given(op_sequences(), st.integers(1, 5))
@settings(max_examples=40, deadline=None)
def test_vector_buffer_matches_reference_on_any_trace(ops, wave):
    """Both engines emit the reference's waves for any trace, and keep
    their structural invariants after every operation."""
    for engine in ("incremental", "scan"):
        a = VectorBuffer(128, 1.0, 100, engine=engine)
        b = RefVectorBuffer(128, 1.0, 100, engine=engine)
        live = set()
        for op, v, s in ops:
            if op == "insert" and v < 128:
                a.insert_many(np.array([v]), np.array([s]))
                b.insert_many(np.array([v]), np.array([s]))
                live.add(v)
            elif op == "increase" and v in live:
                a.update_scores(np.array([v]), np.array([s]))
                b.update_scores(np.array([v]), np.array([s]))
            elif op == "extract" and live:
                ea, eb = a.evict(wave), b.evict(wave)
                np.testing.assert_array_equal(ea, eb)
                live -= set(ea.tolist())
            _check_invariants(a)
        while len(a):
            np.testing.assert_array_equal(a.evict(wave), b.evict(wave))
        assert len(b) == 0


@given(op_sequences())
@settings(max_examples=40, deadline=None)
def test_vector_buffer_wave1_matches_bucket_pq_trace(ops):
    """evict(1) reproduces the port's and the reference's BucketPQ
    extract_max under any insert/increase/extract interleaving."""
    pq, ref_pq = BucketPQ(1.0, 100), RefBucketPQ(1.0, 100)
    vb = VectorBuffer(128, 1.0, 100)
    for op, v, s in ops:
        if op == "insert" and v < 128:
            pq.insert(v, s)
            ref_pq.insert(v, s)
            vb.insert_many(np.array([v]), np.array([s]))
        elif op == "increase" and v in pq:
            pq.increase_key(v, s)
            ref_pq.increase_key(v, s)
            vb.update_scores(np.array([v]), np.array([s]))
        elif op == "extract" and len(pq):
            assert [pq.extract_max()] == [ref_pq.extract_max()] == list(vb.evict(1))
    while len(pq):
        assert [pq.extract_max()] == [ref_pq.extract_max()] == list(vb.evict(1))
    assert len(vb) == 0


def test_vector_buffer_simple_cases_match_the_reference():
    """The reference's hand-written VectorBuffer cases: unique buckets,
    LIFO ties, the monotone guard, waves, stamps kept on a decrease and on
    an increase within the bucket."""
    scores = [0.11, 0.52, 0.33, 0.74, 0.25, 0.96, 0.47, 0.68]
    pq = BucketPQ(1.0, 100)
    vb = VectorBuffer(len(scores), 1.0, 100)
    for i, s in enumerate(scores):
        pq.insert(i, s)
    vb.insert_many(np.arange(len(scores)), np.array(scores))
    assert [pq.extract_max() for _ in scores] == list(vb.evict(len(scores)))

    vb = VectorBuffer(4, 1.0, 100)
    vb.insert_many(np.array([0, 1, 2]), np.array([0.5, 0.5, 0.5]))
    assert list(vb.evict(3)) == [2, 1, 0]

    vb = VectorBuffer(3, 1.0, 100)
    vb.insert_many(np.array([0, 1]), np.array([0.9, 0.1]))
    vb.update_scores(np.array([0]), np.array([0.2]))  # a decrease is ignored
    assert list(vb.evict(1)) == [0]

    vb = VectorBuffer(10, 1.0, 1000)
    vb.insert_many(np.arange(10), np.linspace(0.05, 0.95, 10))
    assert list(vb.evict(3)) == [9, 8, 7] and len(vb) == 7

    vb = VectorBuffer(4, 1.0, 100)
    vb.insert_many(np.array([0, 1]), np.array([0.5, 0.5]))
    vb.update_scores(np.array([0]), np.array([0.3]))
    assert list(vb.evict(2)) == [1, 0]

    vb = VectorBuffer(4, 1.0, 10)
    vb.insert_many(np.array([0, 1]), np.array([0.50, 0.52]))  # one bucket
    vb.update_scores(np.array([0]), np.array([0.53]))  # still that bucket
    assert list(vb.evict(2)) == [1, 0]
