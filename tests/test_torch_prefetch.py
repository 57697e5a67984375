"""repro_torch's PrefetchStream, the resumable in-memory stream and the
stream orderings against repro's: the prefetcher changes when records are
produced, never what a driver sees (labels equal at every depth, for all
three drivers, and equal to the reference's), `tell()` is the consumer's
position, staging shows in `resident_bytes`, a pump error is raised in the
consumer, and no run leaks the pump thread on any exit path."""
import threading

import numpy as np
import pytest

import repro_torch.core.buffcut as port_buffcut
import repro_torch.core.pipeline as port_pipeline
import repro_torch.core.vector_stream as port_vector_stream
from repro.core import PipelineConfig as RefPipelineConfig
from repro.core import VectorizedConfig as RefVectorizedConfig
from repro.core.buffcut import BuffCutConfig as RefBuffCutConfig
from repro.core.buffcut import _buffcut_partition as ref_sequential
from repro.core.multilevel import MultilevelConfig as RefMultilevelConfig
from repro.core.pipeline import _buffcut_partition_pipelined as ref_pipelined
from repro.core.prefetch import PrefetchStream as RefPrefetchStream
from repro.core.vector_stream import _buffcut_partition_vectorized as ref_vectorized
from repro.graphs import NodeStream as RefNodeStream
from repro.graphs import orderings as ref_orderings
from repro.graphs import rmat_graph
from repro_torch.convert import buffcut_config_from_dict, graph_from_numpy
from repro_torch.core import (
    PipelineConfig,
    VectorizedConfig,
    buffcut_partition,
    buffcut_partition_pipelined,
    buffcut_partition_vectorized,
)
from repro_torch.core.multilevel import MultilevelConfig
from repro_torch.core.prefetch import PrefetchStream, maybe_prefetch
from repro_torch.graphs import NodeStream, NodeStreamBase, orderings

PF_SWEEP = (0, 1, 2, 8)

DRIVERS = {
    "sequential": lambda s, cfg, pf: buffcut_partition(s, cfg, prefetch_batches=pf),
    "vectorized": lambda s, cfg, pf: buffcut_partition_vectorized(
        s, cfg, VectorizedConfig(wave=1, chunk=1), prefetch_batches=pf),
    "pipelined": lambda s, cfg, pf: buffcut_partition_pipelined(
        s, cfg, PipelineConfig(prefetch_batches=pf)),
}
REF_DRIVERS = {
    "sequential": lambda s, cfg, pf: ref_sequential(s, cfg, prefetch_batches=pf),
    "vectorized": lambda s, cfg, pf: ref_vectorized(
        s, cfg, RefVectorizedConfig(wave=1, chunk=1), prefetch_batches=pf),
    "pipelined": lambda s, cfg, pf: ref_pipelined(
        s, cfg, RefPipelineConfig(prefetch_batches=pf)),
}
# where each driver's V-cycle is looked up
VCYCLE_OWNERS = {"sequential": port_buffcut, "vectorized": port_vector_stream,
                 "pipelined": port_pipeline}


@pytest.fixture(scope="module")
def base_graph():
    return rmat_graph(128, 5, seed=7)


def _port(g):
    return graph_from_numpy(g.indptr, g.indices, g.edge_w, g.node_w)


def _ref_cfg(engine="sparse") -> RefBuffCutConfig:
    return RefBuffCutConfig(k=4, buffer_size=24, batch_size=12, d_max=48, score="haa",
                            collect_stats=True, ml=RefMultilevelConfig(engine=engine))


def _cfg(engine="sparse"):
    cfg = buffcut_config_from_dict(_ref_cfg().to_dict())
    cfg.ml = MultilevelConfig(engine=engine, device="cpu")
    return cfg


def _pump_threads() -> list:
    return [t for t in threading.enumerate() if t.name == "prefetch-pump" and t.is_alive()]


class FailingStream(NodeStreamBase):
    """An in-memory stream whose iteration raises after `fail_at` records,
    the in-memory stand-in for a parse error mid-file."""

    has_edge_w = has_node_w = True  # what the reference's prefetcher reads

    def __init__(self, g, fail_at: int):
        self._inner = NodeStream(g)
        self.n, self.m = g.n, g.m
        self._fail_at = fail_at

    @property
    def n_total(self) -> float:
        return self._inner.n_total

    @property
    def m_total(self) -> float:
        return self._inner.m_total

    def __iter__(self):
        for i, rec in enumerate(self._inner):
            if i == self._fail_at:
                raise OSError(f"record {i} unreadable")
            yield rec


# --------------------------------------------------------- bit-identity

@pytest.mark.parametrize("engine", ["sparse", "torch"])
@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_prefetch_sweep_bit_identical(driver, engine, base_graph):
    """Sweeping the prefetch depth never changes a label, and every depth
    equals the reference's run at that depth."""
    cfg = _cfg(engine)
    b_mem, s_mem = DRIVERS[driver](_port(base_graph), cfg, 0)
    want_b, want_s = REF_DRIVERS[driver](base_graph, _ref_cfg(), 0)
    np.testing.assert_array_equal(b_mem, want_b)
    for pf in PF_SWEEP:
        b, s = DRIVERS[driver](NodeStream(_port(base_graph)), cfg, pf)
        np.testing.assert_array_equal(b_mem, b)
        assert (s.cut_weight, s.balance, s.n_batches, s.n_hubs, s.block_loads) == (
            want_s.cut_weight, want_s.balance, want_s.n_batches, want_s.n_hubs,
            want_s.block_loads), pf
    if driver != "pipelined":  # without prefetch residency is timing-free
        assert s_mem.peak_resident_bytes == want_s.peak_resident_bytes
    assert not _pump_threads()


def test_record_iteration_matches_unwrapped(base_graph):
    """Record-granular consumption yields the stream's records in order,
    as the reference's prefetcher does, and the consumer-side tell() token
    resumes at the next record."""
    g = _port(base_graph)
    plain = list(NodeStream(g))
    ps = PrefetchStream(NodeStream(g), depth=2, block=7)
    ref = RefPrefetchStream(RefNodeStream(base_graph), depth=2, block=7)
    seen, token, ref_token = [], None, None
    for i, (rec, ref_rec) in enumerate(zip(ps, ref)):
        seen.append(rec)
        assert rec[0] == ref_rec[0] and np.array_equal(rec[1], ref_rec[1])
        if i == len(plain) // 2:
            token, ref_token = ps.tell(), ref.tell()  # the consumer's, not the pump's
    assert token == ref_token == {"index": len(plain) // 2 + 1}
    assert len(seen) == len(plain)
    for (u, nb, w, nw), (u2, nb2, w2, nw2) in zip(plain, seen):
        assert u == u2 and nw == nw2
        assert np.array_equal(nb, nb2) and np.array_equal(w, w2)
    tail = [u for u, *_ in NodeStream(g).iter_from(token)]
    assert tail == [u for u, *_ in plain[len(plain) // 2 + 1:]]
    assert [u for u, *_ in PrefetchStream(NodeStream(g), depth=1).iter_from(token)] == tail
    ps.close()
    ref.close()
    assert not _pump_threads()


def test_node_stream_tell_and_iter_from_match_reference(base_graph):
    g = _port(base_graph)
    s, ref = NodeStream(g), RefNodeStream(base_graph)
    for _ in zip(range(10), s, ref):
        assert s.tell() == ref.tell()
    assert s.tell() == {"index": 10}
    assert [r[0] for r in s.iter_from({"index": 120})] == list(range(120, g.n))
    with pytest.raises(NotImplementedError):
        NodeStreamBase().tell()
    with pytest.raises(NotImplementedError):
        NodeStreamBase().iter_from({"index": 0})


# ------------------------------------------------------------ API edges

def test_constructor_validation(base_graph):
    s = NodeStream(_port(base_graph))
    with pytest.raises(ValueError):
        PrefetchStream(s, depth=0)
    with pytest.raises(ValueError):
        PrefetchStream(s, depth=1, block=0)


def test_maybe_prefetch_identity(base_graph):
    s = NodeStream(_port(base_graph))
    assert maybe_prefetch(s, 0, 16) is s          # 0 = do not wrap
    ps = maybe_prefetch(s, 2, 16)
    assert isinstance(ps, PrefetchStream)
    assert maybe_prefetch(ps, 2, 16) is ps        # never double-wrap
    assert (ps.n, ps.m, ps.n_total, ps.m_total, ps.bytes_read, ps.io_retries) == (
        s.n, s.m, s.n_total, s.m_total, 0, 0)


def test_tell_before_first_record_raises(base_graph):
    ps = PrefetchStream(NodeStream(_port(base_graph)), depth=1)
    with pytest.raises(NotImplementedError):
        ps.tell()
    ps.close()
    assert not _pump_threads()


def test_resident_bytes_counts_staging(base_graph):
    """While blocks sit in the queue, resident_bytes sees them."""
    ps = PrefetchStream(NodeStream(_port(base_graph)), depth=4, block=8)
    it = iter(ps)
    next(it)
    deadline = 100
    while ps.resident_bytes <= ps._inner.resident_bytes and deadline:
        deadline -= 1
        threading.Event().wait(0.01)
    assert ps.resident_bytes > ps._inner.resident_bytes
    ps.close()
    assert ps.resident_bytes == 0
    assert not _pump_threads()


# ----------------------------------------------------------- no leaks

def test_no_thread_leak_consumer_abandon(base_graph):
    """A consumer that breaks mid-stream, or drops the iterator, does not
    leave the pump parked on a full queue."""
    ps = PrefetchStream(NodeStream(_port(base_graph)), depth=1, block=4)
    for i, _rec in enumerate(ps):
        if i == 5:
            break
    ps.close()
    assert not _pump_threads()
    ps = PrefetchStream(NodeStream(_port(base_graph)), depth=1, block=4)
    it = iter(ps)
    next(it)
    del it
    ps.close()
    assert not _pump_threads()


def test_pump_error_is_raised_in_the_consumer(base_graph):
    """A stream error on the pump thread is raised in the consumer after
    the whole blocks before it (the block it broke is not handed over), as
    in the reference's prefetcher, and the pump is joined."""
    seen = {}
    for name, cls in (("port", PrefetchStream), ("ref", RefPrefetchStream)):
        ps = cls(FailingStream(_port(base_graph), fail_at=50), depth=2, block=8)
        seen[name] = []
        with pytest.raises(OSError, match="record 50"):
            for rec in ps:
                seen[name].append(rec[0])
    assert seen["port"] == seen["ref"] == list(range(48))
    assert not _pump_threads()


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_no_thread_leak_on_stream_failure(driver, base_graph):
    """Every driver's exit path closes the prefetcher when the stream
    fails mid-partition."""
    with pytest.raises(OSError, match="record 70"):
        DRIVERS[driver](FailingStream(_port(base_graph), fail_at=70), _cfg(), 2)
    assert not _pump_threads()


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_no_thread_leak_on_driver_failure(driver, base_graph, monkeypatch):
    """A V-cycle that raises (in T3 for the pipelined driver) fails the run
    with its own error, and no pump or worker thread survives it."""
    def failing_vcycle(*a, **kw):
        raise RuntimeError("V-cycle failed")

    monkeypatch.setattr(VCYCLE_OWNERS[driver], "multilevel_partition", failing_vcycle)
    with pytest.raises(RuntimeError, match="V-cycle failed"):
        DRIVERS[driver](_port(base_graph), _cfg(), 2)
    assert not _pump_threads()
    assert not [t for t in threading.enumerate() if t.name == "buffcut-t3" and t.is_alive()]


# ------------------------------------------------------------ orderings

@pytest.mark.parametrize("name", ["source", "random", "konect", "bfs"])
def test_orderings_match_reference(name, base_graph, small_sbm):
    for g in (base_graph, small_sbm):
        fn, ref_fn = getattr(orderings, f"{name}_order"), getattr(ref_orderings, f"{name}_order")
        kw = {"seed": 3} if name in ("random", "konect") else {}
        perm = fn(_port(g), **kw)
        np.testing.assert_array_equal(perm, ref_fn(g, **kw))
        got, want = orderings.apply_order(_port(g), perm), ref_orderings.apply_order(g, perm)
        for a in ("indptr", "indices", "edge_w", "node_w"):
            np.testing.assert_array_equal(getattr(got, a), getattr(want, a))


def test_apply_order_carries_weights(base_graph):
    rng = np.random.default_rng(0)
    g = _port(base_graph)
    g.edge_w = g.edge_w.copy()
    ref_g = rmat_graph(128, 5, seed=7)
    # one weight per undirected edge, the same at both of its entries
    src = np.repeat(np.arange(g.n), np.diff(g.indptr))
    lo, hi = np.minimum(src, g.indices), np.maximum(src, g.indices)
    w = (rng.integers(1, 5, g.n * g.n).astype(np.float32))[lo * g.n + hi]
    g.edge_w, ref_g.edge_w = w, w.copy()
    perm = orderings.random_order(g, seed=1)
    got, want = orderings.apply_order(g, perm), ref_orderings.apply_order(ref_g, perm)
    np.testing.assert_array_equal(got.edge_w, want.edge_w)
    np.testing.assert_array_equal(got.indices, want.indices)
