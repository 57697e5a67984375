"""repro_torch's shard pool: lifecycle and fault injection (marker:
faultinject), held against repro's where both run.

A worker exception, a mid-run consumer abandon and a `FaultyOpener` shard
all leave no pool thread behind and either propagate loudly
(`ShardWorkerError` carrying the root cause) or retry per `RetryPolicy`
with the reference's labels.  A device error in a worker's V-cycle fails
the run (no host fallback).  And `run()` waits for its workers with no
deadline: a run whose workers outlast the shutdown join limit finishes,
where the reference aborts it.
"""
import threading
import time

import numpy as np
import pytest

import repro.distributed.shard_driver as ref_sd
import repro.graphs as R
import repro_torch.core.buffcut as port_buffcut
import repro_torch.distributed.shard_driver as sd
from repro.core.buffcut import BuffCutConfig as RefBuffCutConfig
from repro.core.multilevel import MultilevelConfig as RefMultilevelConfig
from repro_torch.convert import graph_from_numpy
from repro_torch.core import BuffCutConfig, MultilevelConfig
from repro_torch.distributed import ShardPool, ShardWorkerError, shard_partition
from repro_torch.graphs import DiskNodeStream, FaultSchedule, FaultyOpener, NodeStream
from repro_torch.graphs.stream_io import RetryPolicy, shard_ranges, write_packed

pytestmark = pytest.mark.faultinject

_FAST = RetryPolicy(retries=3, backoff_s=0.0005)


@pytest.fixture(scope="module")
def ref_graph():
    return R.rmat_graph(200, 6, seed=9)  # rounds up to n=256


@pytest.fixture(scope="module")
def graph(ref_graph):
    g = ref_graph
    return graph_from_numpy(g.indptr, g.indices, g.edge_w, g.node_w)


@pytest.fixture(scope="module")
def packed_file(graph, tmp_path_factory):
    p = str(tmp_path_factory.mktemp("torch-shard-faults") / "g.bcsr")
    write_packed(graph, p)
    return p


def _cfg(engine="sparse") -> BuffCutConfig:
    return BuffCutConfig(k=4, buffer_size=32, batch_size=8, d_max=64,
                         ml=MultilevelConfig(engine=engine, device="cpu"))


def _ref_cfg() -> RefBuffCutConfig:
    return RefBuffCutConfig(k=4, buffer_size=32, batch_size=8, d_max=64,
                            ml=RefMultilevelConfig(engine="sparse"))


def _pool_threads() -> list:
    return [
        t for t in threading.enumerate()
        if t.name.startswith("shard-worker") and t.is_alive()
    ]


def _make_pool(graph, workers: int, factories=None) -> ShardPool:
    ranges = shard_ranges(graph.n, workers)
    if factories is None:
        factories, _ = sd._make_factories(NodeStream(graph), ranges)
    return ShardPool(
        factories, ranges, _cfg(),
        load_sync_every=1, prefetch_batches=0,
        backend="thread", merge_in_worker=False,
    )


# ------------------------------------------------------------- lifecycle


def test_worker_exception_propagates_and_joins(graph):
    """One worker's failure aborts the barrier, wakes the others, joins
    every thread, and surfaces the root cause — never a hang."""
    baseline = threading.active_count()
    ranges = shard_ranges(graph.n, 4)
    factories, _ = sd._make_factories(NodeStream(graph), ranges)

    def boom():
        raise RuntimeError("injected shard failure")

    factories[2] = boom
    pool = _make_pool(graph, 4, factories)
    pool.start()
    with pytest.raises(ShardWorkerError, match="injected shard failure"):
        pool.run()
    assert not _pool_threads()
    assert threading.active_count() == baseline


def test_midrun_consumer_abandon_joins_cleanly(graph):
    """close() on a pool whose workers are blocked at the sync barrier
    aborts the barrier and joins everything (prefetch abandon idiom)."""
    baseline = threading.active_count()
    ranges = shard_ranges(graph.n, 2)
    factories, _ = sd._make_factories(NodeStream(graph), ranges)
    slow = factories[1]

    def stall_then_run():
        # hold worker 1 back so worker 0 parks inside others_at(0, 0)
        time.sleep(0.5)
        return slow()

    factories[1] = stall_then_run
    pool = _make_pool(graph, 2, factories)
    pool.start()
    time.sleep(0.05)  # let worker 0 reach the barrier
    pool.close()
    assert not _pool_threads()
    assert threading.active_count() == baseline
    # a closed pool reports the abort loudly instead of returning junk
    with pytest.raises(ShardWorkerError, match="closed by consumer"):
        pool.run()


def test_close_is_idempotent_after_success(graph):
    pool = _make_pool(graph, 2)
    pool.start()
    pool.run()
    pool.close()
    pool.close()
    assert (pool.block >= 0).all()
    assert not _pool_threads()


def _slow_factories(stream, ranges, delay_s: float, shard_cls):
    """The pool's factories, each first sleeping `delay_s`: workers that
    outlast a short join limit without being stuck."""
    factories, _ = (sd if shard_cls == "port" else ref_sd)._make_factories(stream, ranges)

    def slow(make):
        def run():
            time.sleep(delay_s)
            return make()
        return run

    return [slow(f) for f in factories]


def test_run_has_no_deadline(graph, ref_graph, monkeypatch):
    """With the join limit at 0.01 s, a run whose workers take 0.3 s each
    finishes with the labels of an unpatched run — where the reference's
    run joins with that limit and aborts ("pool shutdown").  close()
    mid-run under the same limit still aborts and joins every thread."""
    want, _, _ = shard_partition(graph, _cfg(), workers=2, load_sync_every=1)
    monkeypatch.setattr(sd, "_JOIN_TIMEOUT_S", 0.01)
    monkeypatch.setattr(ref_sd, "_JOIN_TIMEOUT_S", 0.01)
    ranges = shard_ranges(graph.n, 2)

    pool = ShardPool(_slow_factories(NodeStream(graph), ranges, 0.3, "port"), ranges, _cfg(),
                     load_sync_every=1, prefetch_batches=0, backend="thread",
                     merge_in_worker=False)
    pool.start()
    pool.run()
    np.testing.assert_array_equal(pool.block, want)
    assert not _pool_threads()

    ref_pool = ref_sd.ShardPool(
        _slow_factories(R.NodeStream(ref_graph), ranges, 0.3, "ref"), ranges, _ref_cfg(),
        load_sync_every=1, prefetch_batches=0, backend="thread", merge_in_worker=False)
    ref_pool.start()
    with pytest.raises(ref_sd.ShardWorkerError, match="pool shutdown"):
        ref_pool.run()
    deadline = time.monotonic() + 10
    while _pool_threads() and time.monotonic() < deadline:
        time.sleep(0.01)  # the reference's aborted workers end at their next barrier

    pool = ShardPool(_slow_factories(NodeStream(graph), ranges, 0.3, "port"), ranges, _cfg(),
                     load_sync_every=1, prefetch_batches=0, backend="thread",
                     merge_in_worker=False)
    pool.start()
    time.sleep(0.05)
    pool.close()  # the workers are asleep in their factories: abort, bounded join
    deadline = time.monotonic() + 10
    while _pool_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not _pool_threads()
    with pytest.raises(ShardWorkerError, match="closed by consumer"):
        pool.run()


# -------------------------------------------------------- fault injection


def test_transient_faults_in_shards_are_absorbed(graph, packed_file):
    """Transient read errors inside worker shards retry per `RetryPolicy`:
    same labels as a clean run and as the reference's, retries counted, no
    leaked threads."""
    baseline = threading.active_count()
    cfg = _cfg()
    clean, s_clean, _ = shard_partition(
        DiskNodeStream(packed_file, 512), cfg, workers=4, load_sync_every=2
    )
    ref, _, _ = ref_sd.shard_partition(R.DiskNodeStream(packed_file, 512), _ref_cfg(),
                                       workers=4, load_sync_every=2)
    np.testing.assert_array_equal(clean, ref)
    sched = FaultSchedule(transient_reads={1, 4, 7, 22})
    faulty = DiskNodeStream(
        packed_file, 512, opener=FaultyOpener(sched), retry=_FAST
    )
    labels, stats, _ = shard_partition(faulty, cfg, workers=4, load_sync_every=2)
    np.testing.assert_array_equal(labels, clean)
    assert stats.cut_weight == s_clean.cut_weight
    assert sched.injected["transient_read"] >= 1
    assert stats.io_retries >= sched.injected["transient_read"] - 1
    assert threading.active_count() == baseline


def test_persistent_faults_propagate_loudly(packed_file):
    """Retry exhaustion inside a worker surfaces as `ShardWorkerError`
    (root OSError chained), with every pool thread joined."""
    baseline = threading.active_count()
    # leave the header + boundary scan clean, then fail every read: some
    # worker exhausts retries=3 no matter how the reads interleave
    sched = FaultSchedule(transient_reads=set(range(100, 2000)))
    faulty = DiskNodeStream(
        packed_file, 512, opener=FaultyOpener(sched), retry=_FAST
    )
    with pytest.raises(ShardWorkerError):
        shard_partition(faulty, _cfg(), workers=4, load_sync_every=2)
    assert not _pool_threads()
    assert threading.active_count() == baseline


def test_device_error_in_a_worker_fails_the_run(graph, monkeypatch):
    """No host fallback: a V-cycle error in one worker aborts the barrier
    and reaches the caller as the root cause."""
    baseline = threading.active_count()
    real = port_buffcut.multilevel_partition
    calls = []

    def lost_card(*a, **kw):
        calls.append(threading.current_thread().name)
        if threading.current_thread().name == "shard-worker-1":
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return real(*a, **kw)

    monkeypatch.setattr(port_buffcut, "multilevel_partition", lost_card)
    with pytest.raises(ShardWorkerError, match="illegal memory access"):
        shard_partition(graph, _cfg("torch"), workers=4, load_sync_every=1)
    assert "shard-worker-1" in calls
    assert not _pool_threads()
    assert threading.active_count() == baseline


def test_process_worker_crash_is_loud(graph):
    """A forked worker dying mid-drive (pipe EOF) is a `ShardWorkerError`,
    and the parent joins its proxy threads and children."""
    baseline = threading.active_count()
    ranges = shard_ranges(graph.n, 2)
    factories, _ = sd._make_factories(NodeStream(graph), ranges)

    def die():
        import os
        os._exit(17)  # simulate a hard crash (OOM-kill style): no err message

    factories[1] = die
    pool = ShardPool(
        factories, ranges, _cfg(),
        load_sync_every=1, prefetch_batches=0,
        backend="process", merge_in_worker=False,
    )
    pool.start()
    with pytest.raises(ShardWorkerError, match="died|closed its pipe"):
        pool.run()
    assert not _pool_threads()
    assert threading.active_count() == baseline
