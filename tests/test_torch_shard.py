"""repro_torch's sharded multi-worker BuffCut against repro's: W ∈ {1, 2, 4}
on memory, METIS text and packed sources, on the host `sparse` engine and
the device `torch` engine (device "cpu"), each held against the reference's
`shard_partition` on its `sparse` engine — labels bit for bit, the merged
cut and loads, every `info` field but timings and the per-worker slim
stats.  Also: determinism and exactness across runs, thread and process
backends alike, the process backend refusing a configuration on the card,
the reconciliation restream, every V-cycle off the calling thread, the
`SharedLoads` barrier properties, and launch counters that lose no count
when several threads launch at once."""
import contextlib
import multiprocessing
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.graphs as R
import repro_torch.core.multilevel_torch as mlt
from repro.core.buffcut import BuffCutConfig as RefBuffCutConfig
from repro.core.multilevel import MultilevelConfig as RefMultilevelConfig
from repro.core.restream import restream_refine as ref_restream_refine
from repro.distributed.shard_driver import shard_partition as ref_shard_partition
from repro_torch.convert import graph_from_numpy
from repro_torch.core import (
    BuffCutConfig,
    MultilevelConfig,
    buffcut_partition,
    edge_cut,
    restream_refine,
)
from repro_torch.distributed import SHARD_BACKENDS, SharedLoads, ShardPool, shard_partition
from repro_torch.graphs import DiskNodeStream, StreamShard, rmat_graph, shard_ranges
from repro_torch.kernels import ell_histogram as eh

WORKER_COUNTS = (2, 4)
# timings and the reference's fallback count (the port has no host fallback)
_UNTIMED_DROP = {"runtime_s", "ml_time_s", "engine_fallbacks", "t3_wait_s"}


def _port(g):
    return graph_from_numpy(g.indptr, g.indices, g.edge_w, g.node_w)


@pytest.fixture(scope="module")
def ref_graph():
    return R.rmat_graph(128, 5, seed=7)


@pytest.fixture(scope="module")
def base_graph(ref_graph):
    return _port(ref_graph)


@pytest.fixture(scope="module")
def disk_files(ref_graph, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch-shard")
    text, packed = str(tmp / "g.graph"), str(tmp / "g.bcsr")
    R.write_metis(ref_graph, text)
    R.write_packed(ref_graph, packed)
    return {"text": text, "packed": packed}


def _cfg(engine="sparse", device="cpu", **kw):
    base = dict(k=4, buffer_size=24, batch_size=12, d_max=48, score="haa",
                collect_stats=True, ml=MultilevelConfig(engine=engine, device=device))
    base.update(kw)
    return BuffCutConfig(**base)


def _ref_cfg():
    return RefBuffCutConfig(k=4, buffer_size=24, batch_size=12, d_max=48, score="haa",
                            collect_stats=True, ml=RefMultilevelConfig(engine="sparse"))


def _sources(src, ref_graph, base_graph, disk_files):
    if src == "memory":
        return base_graph, ref_graph
    return DiskNodeStream(disk_files[src]), R.DiskNodeStream(disk_files[src])


def _untimed(d: dict) -> dict:
    return {k: v for k, v in d.items() if k not in _UNTIMED_DROP}


def _untimed_info(info: dict) -> dict:
    out = {k: v for k, v in info.items() if k not in ("split_s", "pool_s", "per_worker")}
    out["per_worker"] = [_untimed(p) for p in info["per_worker"]]
    return out


# ------------------------------------------------- the port against repro


@pytest.mark.parametrize("engine", ["sparse", "torch"])
@pytest.mark.parametrize("src", ["memory", "text", "packed"])
@pytest.mark.parametrize("workers", (1, *WORKER_COUNTS))
def test_sharded_matches_reference(workers, src, engine, ref_graph, base_graph, disk_files):
    """Labels, merged cut and loads, the whole untimed StreamStats, every
    info field but timings and the per-worker slim stats equal repro's."""
    port_src, ref_src = _sources(src, ref_graph, base_graph, disk_files)
    b, s, info = shard_partition(port_src, _cfg(engine), workers=workers, load_sync_every=2)
    rb, rs, rinfo = ref_shard_partition(ref_src, _ref_cfg(), workers=workers,
                                        load_sync_every=2)
    np.testing.assert_array_equal(b, rb)
    assert s.cut_weight == rs.cut_weight
    assert s.block_loads == rs.block_loads
    assert _untimed(s.to_dict()) == _untimed(rs.to_dict())
    got = _untimed_info(info)
    for extra in ("split_bytes", "merge_bytes"):  # the port's byte split of stream_bytes_read
        got.pop(extra, None)
    assert got == _untimed_info(rinfo)


def test_w1_bit_identical_to_sequential(base_graph):
    """One shard *is* the sequential driver — same labels, same stats."""
    cfg = _cfg("torch")
    b_seq, s_seq = buffcut_partition(base_graph, cfg)
    b_sh, s_sh, info = shard_partition(base_graph, cfg, workers=1)
    np.testing.assert_array_equal(b_seq, b_sh)
    assert _untimed(s_seq.to_dict()) == _untimed(s_sh.to_dict())
    assert info["effective_workers"] == 1
    assert info["cut_cross_shard"] == 0.0


def test_more_workers_than_nodes():
    """W > n clamps to single-node shards; every label still lands."""
    g = rmat_graph(6, 3, seed=2)  # rmat rounds n up to a power of two
    cfg = BuffCutConfig(k=2, buffer_size=4, batch_size=2,
                        ml=MultilevelConfig(engine="sparse", device="cpu"))
    labels, stats, info = shard_partition(g, cfg, workers=2 * g.n, load_sync_every=1)
    assert info["effective_workers"] == g.n
    assert labels.shape == (g.n,) and (labels >= 0).all() and (labels < 2).all()
    assert stats.cut_weight == edge_cut(g, labels)


# --------------------------------------- determinism + exactness, the matrix


@pytest.mark.parametrize("engine", ["sparse", "torch"])
@pytest.mark.parametrize("fmt", ["text", "packed"])
@pytest.mark.parametrize("workers", WORKER_COUNTS)
def test_sharded_deterministic_and_exact(workers, fmt, engine, base_graph, disk_files):
    """Same source, same W, same sync schedule → identical labels across
    runs; merged cut and loads exactly match an offline recomputation, and
    the bytes read are the split scan's, the workers' and the merge's."""
    cfg = _cfg(engine)
    runs = [
        shard_partition(DiskNodeStream(disk_files[fmt]), cfg, workers=workers,
                        load_sync_every=2)
        for _ in range(2)
    ]
    (b1, s1, i1), (b2, s2, _) = runs
    np.testing.assert_array_equal(b1, b2)
    assert s1.cut_weight == s2.cut_weight
    assert s1.block_loads == s2.block_loads
    assert s1.cut_weight == edge_cut(base_graph, b1)
    ref_loads = np.zeros(cfg.k)
    np.add.at(ref_loads, b1, base_graph.node_w.astype(np.float64))
    np.testing.assert_array_equal(np.asarray(s1.block_loads), ref_loads)
    assert i1["cut_intra_shard"] + i1["cut_cross_shard"] == s1.cut_weight
    assert len(i1["per_worker"]) == workers
    assert all(r >= 1 for r in i1["sync_rounds"])
    workers_bytes = sum(p["stream_bytes_read"] for p in i1["per_worker"])
    assert s1.stream_bytes_read == i1["split_bytes"] + workers_bytes + i1["merge_bytes"]
    assert i1["split_bytes"] > 0 and i1["merge_bytes"] > 0


@pytest.mark.parametrize("workers", WORKER_COUNTS)
def test_thread_process_backend_parity(workers, base_graph, ref_graph):
    """Both backends run the same barrier logic → identical labels, and
    the same as the reference's process backend."""
    cfg = _cfg()
    bt, s_t, _ = shard_partition(base_graph, cfg, workers=workers, load_sync_every=2,
                                 backend="thread")
    bp, s_p, info = shard_partition(base_graph, cfg, workers=workers, load_sync_every=2,
                                    backend="process")
    rb, rs, _ = ref_shard_partition(ref_graph, _ref_cfg(), workers=workers,
                                    load_sync_every=2, backend="process")
    np.testing.assert_array_equal(bt, bp)
    np.testing.assert_array_equal(bp, rb)
    assert s_t.cut_weight == s_p.cut_weight == rs.cut_weight
    assert s_t.block_loads == s_p.block_loads == rs.block_loads
    assert info["backend"] == "process"


@pytest.mark.parametrize("engine,device", [("torch", "cuda"), ("auto", "cuda"), ("ell", "cuda"),
                                           ("torch", "cpu"), ("ell", "cpu")])
def test_process_backend_refuses_the_card(engine, device, base_graph, monkeypatch):
    """A V-cycle on the card, or any of torch ops, cannot run in a forked
    child: refused with a ValueError before the device check and before
    any fork."""

    def no_start(self):
        raise AssertionError("the pool started")

    monkeypatch.setattr(ShardPool, "start", no_start)
    with pytest.raises(ValueError, match="fork"):
        shard_partition(base_graph, _cfg(engine, device=device), workers=2, backend="process")
    assert not multiprocessing.active_children()


def test_unknown_backend_and_bad_arguments(base_graph):
    assert SHARD_BACKENDS == ("thread", "process")
    with pytest.raises(ValueError, match="unknown shard backend"):
        shard_partition(base_graph, _cfg(), workers=2, backend="mpi")
    with pytest.raises(ValueError, match="workers"):
        shard_partition(base_graph, _cfg(), workers=0)
    with pytest.raises(ValueError, match="load_sync_every"):
        shard_partition(base_graph, _cfg(), workers=2, load_sync_every=0)


def test_cuda_request_without_a_card_raises(base_graph):
    """The default device is the card; with none, the run raises instead
    of running on the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = BuffCutConfig(k=4, buffer_size=24, batch_size=12,
                        ml=MultilevelConfig(engine="torch"))
    with pytest.raises(RuntimeError, match="CUDA"):
        shard_partition(base_graph, cfg, workers=2)


def test_disk_matches_memory_sharded(base_graph, disk_files):
    """The sharded driver cannot tell where the stream came from either."""
    cfg = _cfg("torch")
    bm, sm, _ = shard_partition(base_graph, cfg, workers=2, load_sync_every=2)
    bd, sd, _ = shard_partition(DiskNodeStream(disk_files["packed"]), cfg, workers=2,
                                load_sync_every=2)
    np.testing.assert_array_equal(bm, bd)
    assert sm.cut_weight == sd.cut_weight
    assert sm.block_loads == sd.block_loads


def test_stream_shard_views(base_graph, disk_files):
    """A shard yields exactly its range's records and reports the parent's
    global aggregates; a factory positioned wrong is loud."""
    from repro_torch.graphs import NodeStream

    parent = NodeStream(base_graph)
    lo, hi = 40, 70
    shard = StreamShard(parent, lambda: parent.iter_from({"index": lo}), lo, hi)
    assert [rec[0] for rec in shard] == list(range(lo, hi))
    assert (shard.n, shard.n_total, shard.m_total) == (parent.n, parent.n_total, parent.m_total)
    bad = StreamShard(parent, lambda: parent.iter_from({"index": lo + 1}), lo, hi)
    with pytest.raises(ValueError, match="positioned wrong"):
        list(bad)
    with pytest.raises(ValueError, match="outside"):
        StreamShard(parent, iter, 0, parent.n + 1)
    assert shard_ranges(10, 4) == R.shard_ranges(10, 4) == [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert shard_ranges(0, 3) == [(0, 0)]


# ----------------------------------------------------- restream reconcile


def test_reconcile_restream_matches_reference(base_graph, ref_graph):
    """The reconciliation the reference's API composes: one priority
    restream pass seeded with the merged labels, exact cut and loads —
    the kept cut equals edge_cut, and the refined labels equal repro's."""
    cfg = _cfg("torch")
    b, s, info = shard_partition(base_graph, cfg, workers=4, load_sync_every=2)
    refined, rinfo = restream_refine(base_graph, b, cfg, 1, order="priority",
                                     initial_cut=s.cut_weight,
                                     initial_loads=np.asarray(s.block_loads))
    rb, rs, _ = ref_shard_partition(ref_graph, _ref_cfg(), workers=4, load_sync_every=2)
    want, winfo = ref_restream_refine(ref_graph, rb, _ref_cfg(), 1, order="priority",
                                      initial_cut=rs.cut_weight,
                                      initial_loads=np.asarray(rs.block_loads))
    np.testing.assert_array_equal(refined, want)
    assert rinfo.passes[0]["cut_before"] == info["cut_pre_reconcile"]
    assert rinfo.cut_weight == edge_cut(base_graph, refined) == winfo.cut_weight


# ------------------------------------------------------- through the API


@pytest.mark.parametrize("engine", ["sparse", "torch"])
@pytest.mark.parametrize("restream_passes", [0, 1])
def test_api_sharded_route_matches_reference(restream_passes, engine, base_graph, ref_graph):
    """`partition(workers=W)` routes through the shard pool, then the
    reconciliation restream: labels, stats and the sharded provenance equal
    the reference API's."""
    from repro.api import partition as ref_partition
    from repro_torch.api import partition

    kw = dict(workers=2, load_sync_every=2, restream_passes=restream_passes,
              restream_order="priority")
    res = partition(base_graph, _cfg(engine), **kw)
    want = ref_partition(ref_graph, _ref_cfg(), **kw)
    np.testing.assert_array_equal(res.labels, want.labels)

    def scheduled(d: dict) -> dict:
        # the API's workers read ahead (prefetch_batches=2): their peak
        # residency depends on when each pump thread staged its blocks
        return {k: v for k, v in _untimed(d).items() if k != "peak_resident_bytes"}

    assert scheduled(res.stats.to_dict()) == scheduled(want.stats.to_dict())
    got = _untimed_info(res.provenance["sharded"])
    wanted = _untimed_info(want.provenance["sharded"])
    for extra in ("split_bytes", "merge_bytes"):
        got.pop(extra, None)
    for info in (got, wanted):
        info["per_worker"] = [scheduled(p) for p in info["per_worker"]]
    assert got == wanted


def test_api_rejects_shard_incapable_driver(base_graph):
    from repro_torch.api import partition

    with pytest.raises(ValueError, match="does not support sharded"):
        partition(base_graph, k=4, driver="fennel", workers=2, device="cpu")


def test_api_process_backend_refuses_torch_before_forking(base_graph, monkeypatch):
    from repro_torch.api import partition

    def no_fork(*a, **kw):
        raise AssertionError("forked")

    monkeypatch.setattr(multiprocessing, "get_context", no_fork)
    with pytest.raises(ValueError, match="backend='process'"):
        partition(base_graph, _cfg("torch"), workers=2, shard_backend="process")


def test_config_serialization_round_trip():
    from repro_torch.api import DriverConfig

    dc = DriverConfig.create(
        k=4, workers=4, load_sync_every=3, shard_backend="process"
    )
    rt = DriverConfig.from_json(dc.to_json())
    assert (rt.workers, rt.load_sync_every, rt.shard_backend) == (4, 3, "process")
    with pytest.raises(ValueError, match="shard_backend"):
        DriverConfig.create(k=4, shard_backend="fork")


# ------------------------------------------------ where the V-cycles run


def test_vcycles_run_on_worker_threads(base_graph, monkeypatch):
    """Every device V-cycle runs off the calling thread, one per batch."""
    seen = []
    engine = mlt.multilevel_partition_torch

    def counted(*a, **kw):
        seen.append(threading.get_ident())
        return engine(*a, **kw)

    monkeypatch.setattr(mlt, "multilevel_partition_torch", counted)
    _, stats, info = shard_partition(base_graph, _cfg("torch"), workers=4, load_sync_every=2)
    assert len(seen) == stats.n_batches == sum(p["n_batches"] for p in info["per_worker"])
    assert threading.get_ident() not in seen
    assert len(set(seen)) == 4


def test_one_worker_runs_host_code_at_a_time(base_graph, monkeypatch):
    """Thread workers take turns between barriers: no two workers are ever
    inside their drivers' batch commits at once, and the labels are those
    of a run without the instrumentation."""
    import repro_torch.core.buffcut as port_buffcut

    want, _, _ = shard_partition(base_graph, _cfg("torch"), workers=4, load_sync_every=2)
    real = port_buffcut.multilevel_partition
    inside, most = [0], [0]
    count = threading.Lock()

    def watched(*a, **kw):
        with count:
            inside[0] += 1
            most[0] = max(most[0], inside[0])
        try:
            time.sleep(0.005)  # widen the window another worker could enter
            return real(*a, **kw)
        finally:
            with count:
                inside[0] -= 1

    monkeypatch.setattr(port_buffcut, "multilevel_partition", watched)
    got, _, _ = shard_partition(base_graph, _cfg("torch"), workers=4, load_sync_every=2)
    np.testing.assert_array_equal(got, want)
    assert most[0] == 1


# ------------------------------------------------------ SharedLoads property


@given(
    st.lists(
        st.tuples(
            st.integers(min_value=0, max_value=2),
            st.lists(
                st.floats(min_value=-8, max_value=8, allow_nan=False),
                min_size=3, max_size=3,
            ),
        ),
        min_size=0, max_size=24,
    )
)
@settings(max_examples=60, deadline=None)
def test_shared_loads_converges_exact(events):
    """Any sequence of per-worker delta publishes converges to the exact
    global loads: per-worker cumulative sums in publish order, workers
    summed in index order — bit-reproducible, no lost updates."""
    W, k = 3, 3
    sl = SharedLoads(W, k)
    ref = [np.zeros(k) for _ in range(W)]
    for w, delta in events:
        sl.publish(w, delta)
        ref[w] = ref[w] + np.asarray(delta, dtype=np.float64)
    for w in range(W):
        sl.finish(w)
    expect = np.zeros(k)
    for w in range(W):
        expect = expect + ref[w]
    assert np.array_equal(sl.total(), expect)


@given(st.integers(min_value=1, max_value=4), st.integers(min_value=1, max_value=5))
@settings(max_examples=25, deadline=None)
def test_shared_loads_threaded_interleaving(workers, rounds):
    """Concurrent workers publishing through the real barrier: every
    `others_at(w, r)` read is the pinned-order sum of the other workers'
    round-r cumulative loads, regardless of thread interleaving."""
    k = 2
    sl = SharedLoads(workers, k)
    seen: list = [None] * workers

    # worker w publishes delta [w+1, 0] each round: cum at round r is (r+1)*(w+1)
    def run(w):
        out = []
        for r in range(rounds):
            sl.publish(w, np.array([w + 1.0, 0.0]))
            out.append(sl.others_at(w, r))
        sl.finish(w)
        seen[w] = out

    threads = [threading.Thread(target=run, args=(w,)) for w in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
    assert all(not t.is_alive() for t in threads)
    for w in range(workers):
        for r in range(rounds):
            expect = np.zeros(k)
            for o in range(workers):
                if o != w:
                    expect = expect + np.array([(r + 1.0) * (o + 1), 0.0])
            assert np.array_equal(seen[w][r], expect)
    total = sl.total()
    assert total[0] == sum(rounds * (w + 1.0) for w in range(workers))


def test_shared_loads_validation():
    sl = SharedLoads(2, 3)
    with pytest.raises(ValueError, match="worker index"):
        sl.publish(2, np.zeros(3))
    with pytest.raises(ValueError, match="shape"):
        sl.publish(0, np.zeros(4))
    sl.finish(0)
    with pytest.raises(ValueError, match="already finished"):
        sl.publish(0, np.zeros(3))
    with pytest.raises(ValueError, match="have not finished"):
        sl.total()


# ----------------------------------------- launch counters under threads


class _CountingLock:
    """A lock that counts how often it was taken."""

    def __init__(self):
        self._lock = threading.Lock()
        self.taken = 0

    def __enter__(self):
        self._lock.acquire()
        self.taken += 1
        return self

    def __exit__(self, *exc):
        self._lock.release()


def test_launch_counter_loses_no_count_across_threads(monkeypatch):
    """block_histogram's card path, driven from 8 threads through a stub
    launcher (no card here), counts every launch, each under the module's
    count lock.  (Whether a bare `+= 1` on a module global loses counts
    depends on where the interpreter switches threads; the lock makes the
    count exact on any interpreter, so the test also checks it is taken.)"""
    calls = []

    def stub_launch(*args):
        calls.append(1)
        return 0

    lock = _CountingLock()
    monkeypatch.setattr(eh, "_LAUNCH", stub_launch)
    monkeypatch.setattr(eh, "_count_lock", lock)
    monkeypatch.setattr(torch.cuda, "device", lambda _dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda _dev: types.SimpleNamespace(cuda_stream=0))
    nbr_blk = torch.zeros((4, 8), dtype=torch.int32)
    nbr_w = torch.ones((4, 8), dtype=torch.float32)
    threads_n, per = 8, 3000
    start = threading.Barrier(threads_n)

    def hammer():
        start.wait()
        for _ in range(per):
            eh._histogram_on_card(nbr_blk, nbr_w, 4)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as the interpreter can
    monkeypatch.setattr(eh, "launches", 0)
    try:
        threads = [threading.Thread(target=hammer) for _ in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert len(calls) == threads_n * per
    assert eh.launches == lock.taken == threads_n * per


# ----------------------------------- the reference's sharded bench numbers


def _bench_sharded():
    import json
    from pathlib import Path

    bench = Path(__file__).resolve().parents[1] / "BENCH_hotpath.json"
    return json.loads(bench.read_text())["sharded"]


@pytest.mark.parametrize("engine", ["sparse", "torch"])
@pytest.mark.parametrize("workers", (1, *WORKER_COUNTS))
def test_reproduces_the_reference_sharded_bench(workers, engine, tmp_path):
    """`benchmarks/bench_shard.py`'s smoke run on the port: the packed
    web-rmat file, k = 8, Q = 256, δ = 128, load sync every 4 batches (the
    process backend on the host engine, threads on the device engine),
    then two priority restream passes seeded from the merge — the cuts
    before and after, the balance and the sync rounds of the committed
    `sharded` section of BENCH_hotpath.json (8743 → 8835 at W = 1)."""
    want = _bench_sharded()["workers"][f"w{workers}"]
    g = R.rmat_graph(4096, 8, seed=11)
    path = str(tmp_path / "rmat.bcsr")
    R.write_packed(g, path)
    cfg = BuffCutConfig(k=8, buffer_size=256, batch_size=128, d_max=256,
                        ml=MultilevelConfig(engine=engine, device="cpu"))
    backend = "process" if workers > 1 and engine == "sparse" else "thread"
    labels, stats, info = shard_partition(DiskNodeStream(path, io_chunk_bytes=1 << 12), cfg,
                                          workers=workers, load_sync_every=4, backend=backend)
    assert stats.cut_weight == want["cut_pre_restream"] == edge_cut(_port(g), labels)
    assert stats.balance == want["balance"]
    assert info["sync_rounds"] == want["sync_rounds"]
    _, rinfo = restream_refine(DiskNodeStream(path, io_chunk_bytes=1 << 12), labels, cfg, 2,
                               order="priority", initial_cut=stats.cut_weight,
                               initial_loads=np.asarray(stats.block_loads))
    assert rinfo.cut_weight == want["cut_post_restream"]
