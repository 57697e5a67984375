"""repro_torch's checkpoint/resume against repro's: the BCKP container and
its integrity checks, the cadence, the structure packers (whose trees equal
the reference's after the same operations), the decision on checkpoints
across the two packages (the file format is shared, resume across them is
refused), and resume conformance — every snapshot that the sequential,
pipelined and vectorized drivers write resumes to the uninterrupted run's
labels bit for bit, from memory, packed and METIS sources, on the host
`sparse` and the device `torch` engine (device "cpu")."""
import dataclasses
import os
import shutil
import struct
import tempfile
import threading
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core.checkpoint as ref_ckmod
import repro.graphs as R
import repro_torch.core.checkpoint as ckmod
from repro.core.buffcut import BuffCutConfig as RefBuffCutConfig
from repro.core.buffcut import _buffcut_partition as ref_partition
from repro.core.buffer import BucketPQ as RefBucketPQ
from repro.core.buffer import VectorBuffer as RefVectorBuffer
from repro.core.checkpoint import CheckpointError as RefCheckpointError
from repro.core.multilevel import MultilevelConfig as RefMultilevelConfig
from repro.core.rescore import RescoreState as RefRescoreState
from repro.core.scores import get_score as ref_get_score
from repro_torch.convert import graph_from_numpy
from repro_torch.core import (
    BuffCutConfig,
    MultilevelConfig,
    PipelineConfig,
    StreamStats,
    VectorizedConfig,
    buffcut_partition,
    buffcut_partition_pipelined,
    buffcut_partition_vectorized,
    edge_cut,
)
from repro_torch.core.buffer import BucketPQ, VectorBuffer
from repro_torch.core.checkpoint import (
    CKPT_MAGIC,
    CheckpointError,
    Checkpointer,
    check_resume,
    load_checkpoint,
    pack_bucket_pq,
    pack_rescore,
    pack_vector_buffer,
    save_checkpoint,
    unpack_bucket_pq,
    unpack_rescore,
    unpack_vector_buffer,
)
from repro_torch.core.rescore import RescoreState
from repro_torch.core.scores import get_score
from repro_torch.graphs import DiskNodeStream, NodeStream, write_metis, write_packed


def _port(g):
    return graph_from_numpy(g.indptr, g.indices, g.edge_w, g.node_w)


def assert_trees_equal(a, b, path="state"):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            assert_trees_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_trees_equal(x, y, f"{path}[{i}]")
    else:
        assert a == b and type(a) is type(b), (path, a, b)


# ------------------------------------------------------------ file format


def _state() -> dict:
    return {
        "kind": "buffcut",
        "n": 64,
        "pos": {"index": 3, "offset": 1234, "skip": 0},
        "block": np.arange(64, dtype=np.int64) % 4,
        "loads": np.linspace(0.0, 1.0, 4),
        "nested": {"list": [1, 2.5, "s", None, np.arange(3)], "flag": True},
    }


def test_save_load_round_trip(tmp_path):
    p = str(tmp_path / "c.ckpt")
    save_checkpoint(p, _state())
    out = load_checkpoint(p)
    assert out["kind"] == "buffcut" and out["n"] == 64 and out["pos"] == _state()["pos"]
    np.testing.assert_array_equal(out["block"], _state()["block"])
    np.testing.assert_array_equal(out["nested"]["list"][4], np.arange(3))
    out["block"][0] = 99  # loaded arrays are writable copies


def test_save_is_atomic_no_tmp_left(tmp_path):
    p = str(tmp_path / "c.ckpt")
    save_checkpoint(p, _state())
    save_checkpoint(p, _state())
    assert os.listdir(tmp_path) == ["c.ckpt"]


@pytest.mark.parametrize("damage, match", [
    ("magic", "bad magic"),
    ("version", "version"),
    ("half", "truncated"),
    ("header", "truncated"),
    ("flip", "CRC"),
    ("garbage", "bad magic"),
])
def test_load_rejects_damaged_files_like_the_reference(damage, match, tmp_path):
    p = str(tmp_path / "c.ckpt")
    save_checkpoint(p, _state())
    raw = bytearray(open(p, "rb").read())
    if damage == "magic":
        raw[:4] = b"NOPE"
    elif damage == "version":
        raw[4:8] = struct.pack("<I", 999)
    elif damage == "half":
        raw = raw[: len(raw) // 2]
    elif damage == "header":
        raw = raw[:10]
    elif damage == "flip":
        raw[len(raw) // 2] ^= 0xFF
    else:
        raw = bytearray(b"not a checkpoint at all" * 4)
    open(p, "wb").write(bytes(raw))
    with pytest.raises(CheckpointError, match=match):
        load_checkpoint(p)
    with pytest.raises(RefCheckpointError, match=match):
        ref_ckmod.load_checkpoint(p)
    assert CKPT_MAGIC == ref_ckmod.CKPT_MAGIC == b"BCKP"


def test_encode_rejects_unserializable(tmp_path):
    with pytest.raises(TypeError):
        save_checkpoint(str(tmp_path / "c"), {"bad": object()})
    with pytest.raises(TypeError):
        save_checkpoint(str(tmp_path / "c"), {1: "non-str key"})


@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(-2**40, 2**40), max_size=6),
       st.lists(st.floats(-1e9, 1e9), max_size=6), st.integers(0, 50))
def test_property_state_tree_round_trip_across_packages(ints, floats, arr_n):
    """Each package reads the other's file into an equal tree."""
    state = {
        "tree": {"ints": ints, "floats": floats, "none": None, "flag": True,
                 "deep": [{"s": "x", "t": (1, 2.5)}]},
        "i64": np.arange(arr_n, dtype=np.int64),
        "f64": np.linspace(-1.0, 1.0, arr_n),
        "bool": (np.arange(arr_n) % 2 == 0),
    }
    with tempfile.TemporaryDirectory() as d:
        port_path, ref_path = os.path.join(d, "p.ckpt"), os.path.join(d, "r.ckpt")
        save_checkpoint(port_path, state)
        ref_ckmod.save_checkpoint(ref_path, state)
        assert open(port_path, "rb").read() == open(ref_path, "rb").read()
        out = load_checkpoint(ref_path)
        assert_trees_equal(out, ref_ckmod.load_checkpoint(port_path))
    assert out["tree"]["deep"] == [{"s": "x", "t": [1, 2.5]}]  # tuples -> lists
    for key in ("i64", "f64", "bool"):
        np.testing.assert_array_equal(out[key], state[key])
        assert out[key].dtype == state[key].dtype


def test_check_resume_guards():
    res = {"kind": "buffcut", "config_json": "{}", "n": 10}
    check_resume(res, "buffcut", "{}", 10)
    with pytest.raises(CheckpointError, match="written by a 'buffcut' run"):
        check_resume(res, "buffcut-vec", "{}", 10)
    with pytest.raises(CheckpointError, match="config does not match"):
        check_resume(res, "buffcut", '{"k": 4}', 10)
    with pytest.raises(CheckpointError, match="10-node stream"):
        check_resume(res, "buffcut", "{}", 11)


def test_checkpointer_crossing_semantics(tmp_path):
    ck = Checkpointer(str(tmp_path / "c"), every=4)
    saves = []
    mk = lambda: saves.append(1) or {"kind": "t"}  # noqa: E731
    assert not ck.maybe_save(3, mk)
    assert ck.maybe_save(4, mk)
    assert not ck.maybe_save(4, mk)
    assert not ck.maybe_save(7, mk)
    assert ck.maybe_save(9, mk)
    assert not ck.maybe_save(11, mk)
    assert ck.maybe_save(32, mk)
    assert not ck.maybe_save(33, mk)
    assert ck.written == 3 and len(saves) == 3


def test_checkpointer_mark_reset_disabled_and_extra(tmp_path):
    ck = Checkpointer(str(tmp_path / "c"), every=4)
    ck.mark(9)
    assert not ck.due(9) and not ck.due(11) and ck.due(12)
    ck.reset()
    assert ck.due(4)
    off = Checkpointer(str(tmp_path / "c"), every=0)
    assert not off.maybe_save(10**9, lambda: pytest.fail("built state"))
    with pytest.raises(ValueError):
        Checkpointer(str(tmp_path / "c"), every=-1)
    p = str(tmp_path / "x.ckpt")
    ck = Checkpointer(p, every=1)
    ck.extra = {"envelope": {"source": "g.bcsr"}}
    ck.maybe_save(1, lambda: {"kind": "t", "n": 1})
    assert load_checkpoint(p)["envelope"] == {"source": "g.bcsr"}


# ---------------------------------------------------------------- packers


def _pq_ops(pq, ops):
    seen = set()
    for v, s in ops:
        if v in seen:
            pq.increase_key(v, s)
        else:
            pq.insert(v, s)
            seen.add(v)


@settings(max_examples=40, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 15), st.floats(0.0, 2.0, allow_nan=False)),
                max_size=40))
def test_property_bucket_pq_round_trip_equals_reference(ops):
    a, ref = BucketPQ(2.0, disc_factor=10), RefBucketPQ(2.0, disc_factor=10)
    _pq_ops(a, ops)
    _pq_ops(ref, ops)
    packed = pack_bucket_pq(a)
    assert_trees_equal(packed, ref_ckmod.pack_bucket_pq(ref))
    b = BucketPQ(2.0, disc_factor=10)
    unpack_bucket_pq(b, packed)
    assert len(a) == len(b)
    assert [a.extract_max() for _ in range(len(a))] == [b.extract_max() for _ in range(len(b))]


@settings(max_examples=40, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 31), st.floats(0.0, 2.0, allow_nan=False)),
                max_size=40), st.integers(0, 10))
def test_property_vector_buffer_round_trip_equals_reference(ops, n_evict):
    a, ref = VectorBuffer(32, 2.0, disc_factor=10), RefVectorBuffer(32, 2.0, disc_factor=10)
    inserted = set()
    for v, s in ops:
        for buf in (a, ref):
            if v in inserted:
                buf.update_scores(np.array([v]), np.array([s]))
            else:
                buf.insert_many(np.array([v]), np.array([s]))
        inserted.add(v)
    for _ in range(min(n_evict, len(a))):
        evicted = a.evict(1)
        np.testing.assert_array_equal(evicted, ref.evict(1))
        inserted.difference_update(evicted.tolist())
    packed = pack_vector_buffer(a)
    assert_trees_equal(packed, ref_ckmod.pack_vector_buffer(ref))
    b = VectorBuffer(32, 2.0, disc_factor=10)
    unpack_vector_buffer(b, packed)
    assert len(a) == len(b)
    np.testing.assert_array_equal(a.in_buf, b.in_buf)
    assert [int(a.evict(1)[0]) for _ in range(len(a))] == [int(b.evict(1)[0])
                                                           for _ in range(len(b))]


def _fill_rescore(st_, score, seed=5):
    n = st_.n
    rng = np.random.default_rng(seed)
    for v in range(10):
        nbrs = rng.choice(n, size=3, replace=False).astype(np.int64)
        st_.observe(v, nbrs, np.ones(3), 1.0)
        if v < 7:  # 7..9 stay adjacency-only: the hub-bypass shape
            st_.member[v] = True
            if st_.buffered_w is not None:
                st_.buffered_w[nbrs] += 1.0
            if st_.blk_w is not None:
                st_.blk_w[v] = rng.random(st_.k)
    st_.assigned_w[:] = rng.random(n)
    if st_.cmax is not None:
        st_.cmax[:] = rng.random(n)


@pytest.mark.parametrize("score", ["haa", "cms", "nss"])
def test_rescore_round_trip_with_hubs_in_flight_equals_reference(score):
    a = RescoreState(24, get_score(score, d_max=100.0), 3)
    ref = RefRescoreState(24, ref_get_score(score, d_max=100.0), 3)
    _fill_rescore(a, score)
    _fill_rescore(ref, score)
    packed = pack_rescore(a)
    assert_trees_equal(packed, ref_ckmod.pack_rescore(ref))
    b = RescoreState(24, get_score(score, d_max=100.0), 3)
    unpack_rescore(b, packed)
    np.testing.assert_array_equal(a.member, b.member)
    np.testing.assert_array_equal(a.assigned_w, b.assigned_w)
    np.testing.assert_array_equal(a.deg_w, b.deg_w)
    if a.blk_w is not None:
        assert set(a.blk_w) == set(b.blk_w)
        for u in a.blk_w:
            np.testing.assert_array_equal(a.blk_w[u], b.blk_w[u])
    vs = np.arange(10, dtype=np.int64)
    for x, y in zip(a.adj.slice(vs), b.adj.slice(vs)):
        np.testing.assert_array_equal(x, y)
    assert a.adj.resident_bytes == b.adj.resident_bytes


def test_unpack_vector_buffer_preserves_member_aliasing():
    spec = get_score("haa", d_max=10.0)
    buf = VectorBuffer(16, 2.0, disc_factor=10)
    st_ = RescoreState(16, spec, 2, member=buf.in_buf)
    buf.insert_many(np.array([3, 5]), np.array([0.5, 1.5]))
    buf2 = VectorBuffer(16, 2.0, disc_factor=10)
    st2 = RescoreState(16, spec, 2, member=buf2.in_buf)
    unpack_vector_buffer(buf2, pack_vector_buffer(buf))
    assert st2.member is buf2.in_buf
    np.testing.assert_array_equal(st2.member, st_.member)


# ------------------------------------------------------ stats and configs


def test_stream_stats_round_trip_with_the_port_fields():
    s = StreamStats(runtime_s=1.5, t3_wait_s=0.25, checkpoints_written=3, n_batches=4,
                    ier_per_batch=[np.float64(0.5), 0.25], evictions=[np.int64(3), 1],
                    block_loads=[1.0, 2.0])
    d = s.to_dict()
    assert d["t3_wait_s"] == 0.25 and d["checkpoints_written"] == 3
    assert "engine_fallbacks" not in d
    back = StreamStats.from_dict(d)
    assert back == s and back.mean_ier == 0.375 and StreamStats().mean_ier == 0.0
    with tempfile.TemporaryDirectory() as tmp:
        p = os.path.join(tmp, "s.ckpt")
        save_checkpoint(p, {"stats": d})
        assert StreamStats.from_dict(load_checkpoint(p)["stats"]) == s


@pytest.mark.parametrize("score", ["haa", "nss"])
def test_buffcut_config_json_round_trip(score):
    from repro_torch.core.scores import ScoreSpec

    for sc in (score, ScoreSpec(kind=score, d_max=7.0, beta=0.5)):
        cfg = BuffCutConfig(k=5, score=sc, ml=MultilevelConfig(engine="torch", device="cpu"))
        assert BuffCutConfig.from_json(cfg.to_json()) == cfg


# --------------------------------------------------- resume conformance

_KW = dict(k=8, buffer_size=64, batch_size=16, eps=0.1)


@pytest.fixture(scope="module")
def graph():
    return R.rmat_graph(300, 6, seed=3)  # rounds up to n=512


@pytest.fixture(scope="module")
def sources(graph, tmp_path_factory):
    d = tmp_path_factory.mktemp("torch-resume-src")
    packed, metis = str(d / "g.bcsr"), str(d / "g.metis")
    write_packed(_port(graph), packed)
    write_metis(_port(graph), metis)
    return {"packed": packed, "metis": metis}


def _source(fmt, sources, graph):
    if fmt == "memory":
        return NodeStream(_port(graph))
    return DiskNodeStream(sources[fmt], io_chunk_bytes=777)


def _cfg(engine="sparse"):
    return BuffCutConfig(**_KW, ml=MultilevelConfig(engine=engine, device="cpu"))


DRIVERS = {
    "buffcut": lambda s, cfg, **kw: buffcut_partition(s, cfg, **kw),
    "buffcut-pipe": lambda s, cfg, **kw: buffcut_partition_pipelined(
        s, cfg, PipelineConfig(queue_depth=2, prefetch_batches=2), **kw),
    "buffcut-vec": lambda s, cfg, **kw: buffcut_partition_vectorized(
        s, cfg, VectorizedConfig(wave=4, chunk=4), **kw),
}


class _Tee:
    """Copies every snapshot a run writes (the live file is overwritten)."""

    def __init__(self, snaps_dir: str):
        self.dir = snaps_dir
        self.copies: list[str] = []
        self._real = ckmod.save_checkpoint

    def __enter__(self):
        def tee(path, state):
            self._real(path, state)
            dst = os.path.join(self.dir, f"{len(self.copies):03d}.ckpt")
            shutil.copy(path, dst)
            self.copies.append(dst)

        ckmod.save_checkpoint = tee
        return self

    def __exit__(self, *exc):
        ckmod.save_checkpoint = self._real


def _sample(seq, limit=4):
    if len(seq) <= limit:
        return list(seq)
    return [seq[i] for i in np.linspace(0, len(seq) - 1, limit).astype(int)]


@pytest.mark.parametrize("engine", ["sparse", "torch"])
@pytest.mark.parametrize("fmt", ["packed", "metis", "memory"])
@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_every_snapshot_resumes_bit_identically(driver, fmt, engine, sources, graph,
                                                tmp_path):
    cfg = _cfg(engine)
    run = DRIVERS[driver]
    base, base_s = run(_source(fmt, sources, graph), cfg)
    with _Tee(str(tmp_path)) as tee:
        got, got_s = run(_source(fmt, sources, graph), cfg,
                         ckpt=Checkpointer(str(tmp_path / "run.ckpt"), every=2))
    np.testing.assert_array_equal(got, base)
    assert got_s.checkpoints_written == len(tee.copies) >= 3
    for snap in _sample(tee.copies):
        state = load_checkpoint(snap)
        assert state["kind"] == driver and 0 < state["pos"]["index"] < graph.n + 1
        res, res_s = run(_source(fmt, sources, graph), cfg, resume=state)
        np.testing.assert_array_equal(res, base, err_msg=os.path.basename(snap))
        assert (res_s.cut_weight, res_s.n_batches, res_s.n_hubs, res_s.balance) == (
            base_s.cut_weight, base_s.n_batches, base_s.n_hubs, base_s.balance)
        assert res_s.checkpoints_written == state["stats"]["checkpoints_written"]
        assert res_s.cut_weight == edge_cut(_port(graph), res)
    if fmt != "memory":
        assert got_s.stream_bytes_read >= os.path.getsize(sources[fmt]) - 64


def test_sequential_snapshots_equal_the_reference_apart_from_identity(sources, graph,
                                                                      tmp_path):
    """Same run, same record: the port's snapshot tree equals the
    reference's except for the config (the port's carries the device) and
    the StreamStats fields only one package has."""
    ref_cfg = RefBuffCutConfig(**_KW, ml=RefMultilevelConfig(engine="sparse"))
    cfg = _cfg()
    want_block, _ = ref_partition(R.DiskNodeStream(sources["packed"]), ref_cfg)
    port_path, ref_path = str(tmp_path / "p.ckpt"), str(tmp_path / "r.ckpt")
    got, _ = buffcut_partition(DiskNodeStream(sources["packed"]), cfg,
                               ckpt=Checkpointer(port_path, every=5))
    ref_partition(R.DiskNodeStream(sources["packed"]), ref_cfg,
                  ckpt=ref_ckmod.Checkpointer(ref_path, every=5))
    np.testing.assert_array_equal(got, want_block)
    port_state, ref_state = load_checkpoint(port_path), ref_ckmod.load_checkpoint(ref_path)
    assert port_state["config_json"] != ref_state["config_json"]
    for state in (port_state, ref_state):
        del state["config_json"]
        for key in ("runtime_s", "ml_time_s", "t3_wait_s", "engine_fallbacks"):
            state["stats"].pop(key, None)
    assert_trees_equal(port_state, ref_state)


def test_resume_across_packages_is_refused_both_ways(sources, graph, tmp_path):
    ref_cfg = RefBuffCutConfig(**_KW, ml=RefMultilevelConfig(engine="sparse"))
    port_path, ref_path = str(tmp_path / "p.ckpt"), str(tmp_path / "r.ckpt")
    buffcut_partition(DiskNodeStream(sources["packed"]), _cfg(),
                      ckpt=Checkpointer(port_path, every=4))
    ref_partition(R.DiskNodeStream(sources["packed"]), ref_cfg,
                  ckpt=ref_ckmod.Checkpointer(ref_path, every=4))
    # the file format is shared: each package reads the other's snapshot
    ref_state = load_checkpoint(ref_path)
    assert_trees_equal(ref_state, ref_ckmod.load_checkpoint(ref_path))
    assert_trees_equal(load_checkpoint(port_path), ref_ckmod.load_checkpoint(port_path))
    with pytest.raises(CheckpointError, match="config does not match"):
        buffcut_partition(DiskNodeStream(sources["packed"]), _cfg(), resume=ref_state)
    with pytest.raises(RefCheckpointError, match="config does not match"):
        ref_partition(R.DiskNodeStream(sources["packed"]), ref_cfg,
                      resume=ref_ckmod.load_checkpoint(port_path))


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_resume_rejects_another_config_or_driver(driver, sources, graph, tmp_path):
    p = str(tmp_path / "c.ckpt")
    DRIVERS[driver](_source("packed", sources, graph), _cfg(), ckpt=Checkpointer(p, every=4))
    state = load_checkpoint(p)
    with pytest.raises(CheckpointError, match="config does not match"):
        DRIVERS[driver](_source("packed", sources, graph),
                        dataclasses.replace(_cfg(), k=9), resume=state)
    # the device is part of the identity: a CPU snapshot is no card run's
    with pytest.raises(CheckpointError, match="config does not match"):
        DRIVERS[driver](_source("packed", sources, graph), _cfg("torch"), resume=state)
    other = "buffcut-vec" if driver != "buffcut-vec" else "buffcut"
    with pytest.raises(CheckpointError, match="written by a"):
        DRIVERS[other](_source("packed", sources, graph), _cfg(), resume=state)


def test_resume_rejects_a_corrupted_snapshot(sources, graph, tmp_path):
    p = str(tmp_path / "c.ckpt")
    buffcut_partition(_source("packed", sources, graph), _cfg(), ckpt=Checkpointer(p, every=2))
    raw = bytearray(open(p, "rb").read())
    raw[len(raw) // 2] ^= 0x55
    open(p, "wb").write(bytes(raw))
    with pytest.raises(CheckpointError, match="CRC"):
        load_checkpoint(p)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_pipelined_tokens_name_the_consumed_record_through_the_pump(prefetch, sources, graph,
                                                                    tmp_path):
    """The pipelined snapshot's token is the disk stream's own position
    after the record T2 consumed last, with or without the prefetch pump,
    and a resume reopens the file there at either depth."""
    cfg = _cfg()
    path = str(tmp_path / "s16.bcsr")  # 16-record sections: the offset moves
    write_packed(_port(graph), path, section_records=16)
    base, _ = buffcut_partition(DiskNodeStream(path), cfg)
    snaps = tmp_path / "snaps"
    snaps.mkdir()
    with _Tee(str(snaps)) as tee:
        buffcut_partition_pipelined(DiskNodeStream(path, io_chunk_bytes=777), cfg,
                                    PipelineConfig(prefetch_batches=prefetch),
                                    ckpt=Checkpointer(str(tmp_path / "run.ckpt"), every=3))
    assert len(tee.copies) >= 3
    for snap in _sample(tee.copies, 3):
        state = load_checkpoint(snap)
        pos = state["pos"]
        fresh = DiskNodeStream(path, io_chunk_bytes=777)
        for v, *_ in fresh:
            if v + 1 == pos["index"]:
                assert fresh.tell() == pos
                break
        assert pos["offset"] > 64
        for depth in (0, 2):
            res, _ = buffcut_partition_pipelined(
                DiskNodeStream(path), cfg, PipelineConfig(prefetch_batches=depth),
                resume=state)
            np.testing.assert_array_equal(res, base)


def _pipeline_threads():
    return [t for t in threading.enumerate()
            if t.name in ("prefetch-pump", "buffcut-t3") and t.is_alive()]


def test_pipelined_checkpoint_failure_leaves_no_threads(sources, graph, tmp_path):
    real = ckmod.save_checkpoint

    def boom(path, state):
        raise RuntimeError("disk full")

    ckmod.save_checkpoint = boom
    try:
        with pytest.raises(RuntimeError, match="disk full"):
            buffcut_partition_pipelined(_source("packed", sources, graph), _cfg(),
                                        PipelineConfig(prefetch_batches=2),
                                        ckpt=Checkpointer(str(tmp_path / "c"), every=2))
    finally:
        ckmod.save_checkpoint = real
    deadline = time.monotonic() + 6.0
    while _pipeline_threads() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not _pipeline_threads()


def test_vectorized_checkpoint_needs_the_incremental_engine(sources, graph, tmp_path):
    with pytest.raises(ValueError, match="incremental"):
        buffcut_partition_vectorized(_source("packed", sources, graph), _cfg(),
                                     VectorizedConfig(engine="scan"),
                                     ckpt=Checkpointer(str(tmp_path / "c"), every=2))


def test_resumed_stats_carry_the_first_run(sources, graph, tmp_path):
    cfg = dataclasses.replace(_cfg(), collect_stats=True)
    base, base_s = buffcut_partition(_source("metis", sources, graph), cfg)
    with _Tee(str(tmp_path)) as tee:
        buffcut_partition(_source("metis", sources, graph), cfg,
                          ckpt=Checkpointer(str(tmp_path / "run.ckpt"), every=3))
    state = load_checkpoint(tee.copies[len(tee.copies) // 2])
    res, res_s = buffcut_partition(_source("metis", sources, graph), cfg, resume=state)
    np.testing.assert_array_equal(res, base)
    assert res_s.ier_per_batch == base_s.ier_per_batch
    assert res_s.evictions == base_s.evictions
    assert res_s.stream_bytes_read >= state["stats"]["stream_bytes_read"]


@settings(max_examples=5, deadline=None)
@given(st.integers(0, 10**6), st.sampled_from(sorted(DRIVERS)))
def test_property_random_kill_point_resumes(seed, driver):
    """A run killed at any snapshot resumes to the uninterrupted labels.
    The temporary directory is made inside the test body, so hypothesis
    sees no function-scoped fixture."""
    g = R.rmat_graph(300, 6, seed=3)
    cfg = _cfg()
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "g.bcsr")
        write_packed(_port(g), src)
        run = DRIVERS[driver]
        base, _ = run(DiskNodeStream(src), cfg)
        snaps = os.path.join(d, "snaps")
        os.makedirs(snaps)
        with _Tee(snaps) as tee:
            run(DiskNodeStream(src), cfg, ckpt=Checkpointer(os.path.join(d, "c"), every=1))
        snap = tee.copies[seed % len(tee.copies)]
        res, _ = run(DiskNodeStream(src), cfg, resume=load_checkpoint(snap))
    np.testing.assert_array_equal(res, base)
