"""repro_torch's restreaming (paper §3.5) against repro's: the incremental
cut maintainer, `MicroRestreamer`, and `restream_refine` in stream and
priority order — the reference's cuts 808 → 934 and 808 → 947 on the
out-of-core grid reproduced, disk equal to memory equal to the reference
on the host `sparse` and the device `torch` engine (device "cpu"), resume
from every snapshot bit-identical, and a device error in a batch reaching
the caller (the port has no host fallback)."""
import importlib
import os
import shutil
import threading

import numpy as np
import pytest

import repro.graphs as R
import repro_torch.core.checkpoint as ckmod
from repro.core.buffcut import BuffCutConfig as RefBuffCutConfig
from repro.core.buffcut import _buffcut_partition as ref_partition
from repro.core.fennel import FennelParams as RefFennelParams
from repro.core.metrics import IncrementalCut as RefIncrementalCut
from repro.core.metrics import internal_edge_ratio as ref_internal_edge_ratio
from repro.core.multilevel import MultilevelConfig as RefMultilevelConfig
from repro.core.rescore import AdjacencyCache as RefAdjacencyCache
from repro.core.restream import MicroRestreamer as RefMicroRestreamer
from repro.core.restream import restream_refine as ref_restream_refine
from repro_torch.convert import graph_from_numpy
from repro_torch.core import (
    BuffCutConfig,
    Checkpointer,
    IncrementalCut,
    MicroRestreamer,
    MultilevelConfig,
    RestreamInfo,
    buffcut_partition,
    edge_cut,
    internal_edge_ratio,
    load_checkpoint,
    restream,
    restream_pass,
    restream_refine,
)
from repro_torch.core.fennel import FennelParams
from repro_torch.core.rescore import AdjacencyCache
from repro_torch.graphs import (
    CSRGraph,
    DiskNodeStream,
    NodeStream,
    grid_mesh_to_disk,
    permute_to_disk,
    star_graph,
    write_metis,
    write_packed,
)


# the function `restream` shadows its module's name on the package
port_restream = importlib.import_module("repro_torch.core.restream")


def _port(g):
    return graph_from_numpy(g.indptr, g.indices, g.edge_w, g.node_w)


def _cfg(engine="sparse", **kw):
    base = dict(k=4, buffer_size=24, batch_size=12, d_max=48, score="haa",
                ml=MultilevelConfig(engine=engine, device="cpu"))
    base.update(kw)
    return BuffCutConfig(**base)


def _ref_cfg(**kw):
    base = dict(k=4, buffer_size=24, batch_size=12, d_max=48, score="haa",
                ml=RefMultilevelConfig(engine="sparse"))
    base.update(kw)
    return RefBuffCutConfig(**base)


def _strip(passes):
    """The reference's pass log less its fallback count (the port has none)."""
    return [{k: v for k, v in p.items() if k != "engine_fallbacks"} for p in passes]


# ------------------------------------------------ incremental cut maintainer


def _random_adjacency(rng, n: int, with_self_loops: bool):
    edges: dict = {}
    for _ in range(3 * n):
        u, v = int(rng.integers(n)), int(rng.integers(n))
        if not with_self_loops and u == v:
            continue
        a, b = min(u, v), max(u, v)
        edges[(a, b)] = edges.get((a, b), 0.0) + float(rng.integers(1, 5))
    adj = {v: ([], []) for v in range(n)}
    for (a, b), w in edges.items():
        adj[a][0].append(b)
        adj[a][1].append(w)
        if b != a:
            adj[b][0].append(a)
            adj[b][1].append(w)
    return edges, {v: (np.asarray(i, dtype=np.int64), np.asarray(w, dtype=np.float64))
                   for v, (i, w) in adj.items()}


def _brute_cut(edges, block) -> float:
    return float(sum(w for (a, b), w in edges.items() if a != b and block[a] != block[b]))


@pytest.mark.parametrize("with_self_loops", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_incremental_cut_matches_recompute_and_reference(seed, with_self_loops):
    rng = np.random.default_rng(seed)
    n, k = 40, 4
    edges, adj = _random_adjacency(rng, n, with_self_loops)
    block = rng.integers(0, k, n).astype(np.int64)
    cm, ref = IncrementalCut(_brute_cut(edges, block)), RefIncrementalCut(_brute_cut(edges, block))
    for _ in range(30):
        b = int(rng.integers(1, 6))
        bnodes = rng.choice(n, size=b, replace=False).astype(np.int64)
        nbr = np.concatenate([adj[int(v)][0] for v in bnodes])
        w = np.concatenate([adj[int(v)][1] for v in bnodes])
        degs = np.array([adj[int(v)][0].shape[0] for v in bnodes], dtype=np.int64)
        cm.stage(bnodes, degs, nbr, w, block)
        ref.stage(bnodes, degs, nbr, w, block)
        block[bnodes] = rng.integers(0, k, b)
        d = cm.commit(bnodes, block[bnodes], degs, nbr, w, block)
        assert d == ref.commit(bnodes, block[bnodes], degs, nbr, w, block)
        assert cm.cut_weight == pytest.approx(_brute_cut(edges, block))
        assert cm.snapshot() == ref.snapshot()


def test_incremental_cut_protocol_and_edge_deltas():
    cm = IncrementalCut(0.0)
    one, e = np.array([0], dtype=np.int64), np.empty(0, dtype=np.int64)
    with pytest.raises(RuntimeError, match="before stage"):
        cm.commit(one, np.array([1]), np.array([0]), e, np.empty(0), np.zeros(2, np.int64))
    cm.stage(one, np.array([0]), e, np.empty(0), np.zeros(2, np.int64))
    with pytest.raises(RuntimeError, match="twice"):
        cm.stage(one, np.array([0]), e, np.empty(0), np.zeros(2, np.int64))
    with pytest.raises(RuntimeError, match="between stage and commit"):
        cm.snapshot()
    with pytest.raises(RuntimeError, match="between stage and commit"):
        cm.apply_edge_delta(0, 1, 1.0, np.zeros(2, np.int64))
    block = np.array([0, 1, 1, -1])
    cm, ref = IncrementalCut(5.0), RefIncrementalCut(5.0)
    for u, v, w in ((0, 1, 2.0), (1, 2, 3.0), (2, 2, 4.0), (0, 3, 1.5), (0, 1, -2.0)):
        assert cm.apply_edge_delta(u, v, w, block) == ref.apply_edge_delta(u, v, w, block)
    assert cm.cut_weight == ref.cut_weight == 6.5


@pytest.mark.parametrize("seed", [5, 6])
def test_internal_edge_ratio_equals_reference(seed):
    g = R.rmat_graph(96, 5, seed=seed)
    batch = np.random.default_rng(seed).choice(g.n, 20, replace=False)
    assert internal_edge_ratio(_port(g), batch) == ref_internal_edge_ratio(g, batch)


# --------------------------------------- the reference's out-of-core cuts


@pytest.fixture(scope="module")
def outofcore(tmp_path_factory):
    """`benchmarks/bench_restream.py`'s smoke setting: a 64x64 grid
    streamed to disk (n = 4096, 16x the buffer), io chunks of 4 KiB."""
    path = str(tmp_path_factory.mktemp("torch-ooc") / "grid.bcsr")
    grid_mesh_to_disk(64, path)
    return path


@pytest.mark.parametrize("engine", ["sparse", "torch"])
@pytest.mark.parametrize("order, cut_after", [("stream", 934.0), ("priority", 947.0)])
def test_restream_reproduces_the_reference_cuts(order, cut_after, engine, outofcore):
    cfg = BuffCutConfig(k=4, buffer_size=256, batch_size=128, d_max=64,
                        ml=MultilevelConfig(engine=engine, device="cpu"))
    stream = DiskNodeStream(outofcore, io_chunk_bytes=1 << 12)
    b0, s0 = buffcut_partition(stream, cfg)
    assert s0.cut_weight == 808.0
    b1, info = restream_refine(stream, b0, cfg, 2, order=order, initial_cut=s0.cut_weight,
                               initial_loads=np.asarray(s0.block_loads))
    assert info.passes[0]["cut_before"] == 808.0 and info.cut_weight == cut_after
    g = R.grid_mesh_graph(64)
    assert info.cut_weight == edge_cut(_port(g), b1)
    loads = np.bincount(b1, minlength=cfg.k)
    assert loads.max() <= np.ceil(1.03 * g.n / cfg.k)
    ref_cfg = RefBuffCutConfig(k=4, buffer_size=256, batch_size=128, d_max=64,
                               ml=RefMultilevelConfig(engine="sparse"))
    rs = R.DiskNodeStream(outofcore, io_chunk_bytes=1 << 12)
    r0, rs0 = ref_partition(rs, ref_cfg)
    r1, rinfo = ref_restream_refine(rs, r0, ref_cfg, 2, order=order,
                                    initial_cut=rs0.cut_weight,
                                    initial_loads=np.asarray(rs0.block_loads))
    np.testing.assert_array_equal(b1, r1)
    assert info.passes == _strip(rinfo.passes)
    assert (info.balance, info.n_total, info.m_total, info.stream_bytes_read,
            info.peak_resident_bytes) == (rinfo.balance, rinfo.n_total, rinfo.m_total,
                                          rinfo.stream_bytes_read, rinfo.peak_resident_bytes)



def _restream_at_full_width_ratios(side: int, path: str) -> dict:
    """`grid_mesh_to_disk(side)` at the ratios of the port's full-width run
    (k = 32, buffer n/4, batch n/32, the paper's d_max, HAA and
    disc_factor; chip_smoke's `full_width_config` at side 1024) through
    both packages on the host `sparse` engine: BuffCut, then one restream
    pass in each order.  Checks labels, pass logs and the kept cut equal
    between the packages and to `edge_cut`; returns {order: pass log}."""
    n = side * side
    grid_mesh_to_disk(side, path)
    kw = dict(k=32, eps=0.03, buffer_size=n // 4, batch_size=n // 32, d_max=10000.0,
              score="haa", disc_factor=1000)
    cfg = BuffCutConfig(**kw, ml=MultilevelConfig(engine="sparse", device="cpu"))
    ref_cfg = RefBuffCutConfig(**kw, ml=RefMultilevelConfig(engine="sparse"))
    b0, s0 = buffcut_partition(DiskNodeStream(path), cfg)
    r0, rs0 = ref_partition(R.DiskNodeStream(path), ref_cfg)
    np.testing.assert_array_equal(b0, r0)
    assert s0.cut_weight == rs0.cut_weight
    g = _port(R.grid_mesh_graph(side))
    logs = {}
    for order in ("priority", "stream"):
        b1, info = restream_refine(DiskNodeStream(path), b0, cfg, 1, order=order,
                                   initial_cut=s0.cut_weight,
                                   initial_loads=np.asarray(s0.block_loads))
        r1, rinfo = ref_restream_refine(R.DiskNodeStream(path), r0, ref_cfg, 1, order=order,
                                        initial_cut=rs0.cut_weight,
                                        initial_loads=np.asarray(rs0.block_loads))
        np.testing.assert_array_equal(b1, r1)
        assert info.passes == _strip(rinfo.passes)
        assert info.cut_weight == edge_cut(g, b1)
        logs[order] = info.passes[0]
    return logs


@pytest.mark.parametrize("side", [128, 256])
def test_restream_at_the_full_width_ratios_matches_the_reference(side, tmp_path):
    logs = _restream_at_full_width_ratios(side, str(tmp_path / "grid.bcsr"))
    for log in logs.values():
        assert log["n_batches"] == 32 and log["moved"] > 0

# ------------------------------------------------------- disk == memory


ORDERINGS = {"natural": None, "bfs": R.bfs_order, "konect": lambda g: R.konect_order(g, seed=1)}


@pytest.fixture(scope="module")
def base_graph():
    return R.rmat_graph(128, 5, seed=7)


@pytest.fixture(scope="module")
def disk_files(base_graph, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch-restream")
    natural = str(tmp / "g.bcsr")
    write_packed(_port(base_graph), natural)
    paths = {"natural": natural}
    for name, fn in ORDERINGS.items():
        if fn is not None:
            paths[name] = str(tmp / f"g_{name}.bcsr")
            permute_to_disk(natural, fn(base_graph), paths[name], shard_nodes=37)
    return paths


@pytest.mark.parametrize("order", sorted(ORDERINGS))
@pytest.mark.parametrize("engine", ["sparse", "torch"])
@pytest.mark.parametrize("rorder", ["stream", "priority"])
def test_restream_disk_matches_memory_and_reference(rorder, engine, order, base_graph,
                                                   disk_files):
    cfg = _cfg(engine)
    fn = ORDERINGS[order]
    gm = base_graph if fn is None else R.apply_order(base_graph, fn(base_graph))
    b_mem, s_mem = buffcut_partition(_port(gm), cfg)
    b_mem2, i_mem = restream_refine(_port(gm), b_mem, cfg, 1, order=rorder,
                                    initial_cut=s_mem.cut_weight)
    ds = DiskNodeStream(disk_files[order])
    b_disk, s_disk = buffcut_partition(ds, cfg)
    b_disk2, i_disk = restream_refine(ds, b_disk, cfg, 1, order=rorder,
                                      initial_cut=s_disk.cut_weight)
    np.testing.assert_array_equal(b_mem2, b_disk2)
    assert (i_mem.cut_weight, i_mem.balance, i_mem.passes) == (
        i_disk.cut_weight, i_disk.balance, i_disk.passes)
    assert i_mem.n_total == i_disk.n_total == ds.n_total
    assert i_mem.m_total == i_disk.m_total == ds.m_total
    assert i_disk.cut_weight == edge_cut(_port(gm), b_disk2)
    r0, rs0 = ref_partition(gm, _ref_cfg())
    r1, rinfo = ref_restream_refine(gm, r0, _ref_cfg(), 1, order=rorder,
                                    initial_cut=rs0.cut_weight)
    np.testing.assert_array_equal(b_disk2, r1)
    assert i_disk.cut_weight == rinfo.cut_weight and i_disk.passes == _strip(rinfo.passes)


@pytest.mark.parametrize("rorder", ["stream", "priority"])
def test_restream_metis_text_matches_packed(rorder, base_graph, disk_files, tmp_path):
    cfg = _cfg()
    p_txt = str(tmp_path / "g.metis")
    write_metis(_port(base_graph), p_txt)
    out = {}
    for name, src in (("text", DiskNodeStream(p_txt, io_chunk_bytes=97)),
                      ("binary", DiskNodeStream(disk_files["natural"]))):
        b0, s0 = buffcut_partition(src, cfg)
        out[name] = restream_refine(src, b0, cfg, 2, order=rorder, initial_cut=s0.cut_weight)
    np.testing.assert_array_equal(out["text"][0], out["binary"][0])
    assert out["text"][1].cut_weight == out["binary"][1].cut_weight


@pytest.mark.parametrize("rorder", ["stream", "priority"])
def test_restream_prefetch_and_seeds_change_no_label(rorder, base_graph, disk_files):
    cfg = _cfg()
    b0, s0 = buffcut_partition(DiskNodeStream(disk_files["bfs"]), cfg)
    want, winfo = restream_refine(DiskNodeStream(disk_files["bfs"]), b0, cfg, 2, order=rorder)
    for kw in (dict(prefetch_batches=2),
               dict(initial_cut=s0.cut_weight, initial_loads=np.asarray(s0.block_loads)),
               dict(initial_cut=s0.cut_weight, prefetch_batches=1)):
        got, info = restream_refine(DiskNodeStream(disk_files["bfs"]), b0, cfg, 2,
                                    order=rorder, **kw)
        np.testing.assert_array_equal(got, want)
        assert info.cut_weight == winfo.cut_weight and info.passes == winfo.passes
    assert not [t for t in threading.enumerate() if t.name == "prefetch-pump" and t.is_alive()]


def test_priority_order_is_deterministic_and_balanced(base_graph):
    cfg = _cfg()
    g = _port(base_graph)
    b0, _ = buffcut_partition(g, cfg)
    b1, i1 = restream_refine(g, b0, cfg, 2, order="priority")
    b2, i2 = restream_refine(g, b0, cfg, 2, order="priority")
    np.testing.assert_array_equal(b1, b2)
    assert i1.cut_weight == i2.cut_weight and ((b1 >= 0) & (b1 < cfg.k)).all()
    assert np.bincount(b1, minlength=4).max() <= np.ceil(1.03 * g.n / 4)


@pytest.mark.parametrize("order", ["stream", "priority"])
def test_hub_bypass_keeps_residency_degree_independent(order):
    g = star_graph(300)
    cfg = BuffCutConfig(k=4, buffer_size=32, batch_size=16, d_max=50,
                        ml=MultilevelConfig(engine="sparse", device="cpu"))
    b0, _ = buffcut_partition(g, cfg)
    b1, info = restream_refine(g, b0, cfg, 1, order=order)
    assert info.passes[0]["n_hubs"] == 1 and (b1 >= 0).all()
    assert info.cut_weight == edge_cut(g, b1)


def test_restream_legacy_wrappers_compose(base_graph):
    cfg = _cfg()
    g = _port(base_graph)
    b0, _ = buffcut_partition(g, cfg)
    two = restream(g, b0, cfg, 2)
    one = restream_pass(g, restream_pass(g, b0, cfg), cfg)
    np.testing.assert_array_equal(two, one)


def test_restream_validates_inputs(base_graph):
    cfg = _cfg()
    g = _port(base_graph)
    with pytest.raises(ValueError, match="restream order"):
        restream_refine(g, np.zeros(g.n, np.int64), cfg, 1, order="nope")
    with pytest.raises(ValueError, match="passes must be"):
        restream_refine(g, np.zeros(g.n, np.int64), cfg, -1)
    with pytest.raises(ValueError, match="entries"):
        restream_refine(g, np.zeros(3, np.int64), cfg, 1)
    incomplete = np.zeros(g.n, np.int64)
    incomplete[0] = -1
    with pytest.raises(ValueError, match="complete"):
        restream_refine(g, incomplete, cfg, 1)
    with pytest.raises(ValueError, match="blocks"):
        restream_refine(g, np.zeros(g.n, np.int64), cfg, 1, initial_cut=0.0,
                        initial_loads=np.zeros(3))


def test_isolated_nodes_restream_on_both_backends(tmp_path):
    g = CSRGraph.from_edges(8, np.array([[0, 1], [1, 2], [4, 5], [5, 6], [0, 2], [4, 6]]))
    path = str(tmp_path / "iso.metis")
    write_metis(g, path)
    cfg = BuffCutConfig(k=2, buffer_size=4, batch_size=2, d_max=16,
                        ml=MultilevelConfig(engine="sparse", device="cpu"))
    b0, _ = buffcut_partition(g, cfg)
    b_mem, info_mem = restream_refine(g, b0, cfg, 1, order="priority")
    b_disk, info_disk = restream_refine(DiskNodeStream(path, io_chunk_bytes=7), b0, cfg, 1,
                                        order="priority")
    np.testing.assert_array_equal(b_mem, b_disk)
    assert info_mem.cut_weight == info_disk.cut_weight == edge_cut(g, b_mem)


@pytest.mark.parametrize("order", ["stream", "priority"])
def test_memory_ceiling_on_16x_graph(order, outofcore):
    io_chunk = 1 << 12
    cfg = BuffCutConfig(k=4, buffer_size=256, batch_size=128, d_max=64,
                        ml=MultilevelConfig(engine="sparse", device="cpu"))
    stream = DiskNodeStream(outofcore, io_chunk_bytes=io_chunk)
    assert stream.n >= 16 * cfg.buffer_size
    b0, s0 = buffcut_partition(stream, cfg)
    _, info = restream_refine(stream, b0, cfg, 2, order=order, initial_cut=s0.cut_weight)
    per_node = 8 * 16 + 96
    bound = (cfg.buffer_size + 2 * cfg.batch_size + 2) * per_node + 2 * io_chunk + per_node
    assert 0 < info.peak_resident_bytes <= bound
    assert info.peak_resident_bytes < 0.5 * os.path.getsize(outofcore) * 4


def test_restream_info_round_trips():
    info = RestreamInfo(cut_weight=3.5, order="priority",
                        passes=[{"order": "priority", "n_batches": 2}])
    d = info.to_dict()
    assert d["cut_weight"] == 3.5 and d["passes"][0]["n_batches"] == 2
    assert RestreamInfo(**d) == info


# --------------------------------------------------- replay-count guard


class _ShrinkingStream(NodeStream):
    """Replays fully `full_iters` times, then loses its tail."""

    def __init__(self, g, full_iters: int, keep: int):
        super().__init__(g)
        self._iters, self._keep, self._full = 0, keep, full_iters

    def __iter__(self):
        self._iters += 1
        it = super().__iter__()
        if self._iters <= self._full:
            yield from it
            return
        for i, rec in enumerate(it):
            if i >= self._keep:
                return
            yield rec


def test_replay_guard_distinguishes_truncation_from_one_shot(base_graph):
    cfg = _cfg()
    g = _port(base_graph)
    b0, s0 = buffcut_partition(g, cfg)
    with pytest.raises(ValueError, match="truncated mid-pass"):
        restream_refine(_ShrinkingStream(g, 0, g.n // 2), b0, cfg, 1)
    with pytest.raises(ValueError, match="during restream pass 1"):
        restream_refine(_ShrinkingStream(g, 0, g.n // 2), b0, cfg, 1,
                        initial_cut=s0.cut_weight, initial_loads=np.asarray(s0.block_loads))
    with pytest.raises(ValueError, match="one-shot stream"):
        restream_refine(_ShrinkingStream(g, 0, 0), b0, cfg, 1, initial_cut=s0.cut_weight,
                        initial_loads=np.asarray(s0.block_loads))


# ------------------------------------------------------ MicroRestreamer


def _micro_case(base_graph, cls, adj_cls, params_cls, cfg, block, loads, cm):
    g = base_graph
    p = params_cls(k=cfg.k, n_total=float(g.n), m_total=float(g.m), eps=cfg.eps,
                   gamma=cfg.gamma)
    adj = adj_cls()
    micro = cls(g.n, block, loads, cm, cfg, p, adj)
    out = []
    for bnodes in (np.arange(0, 12), np.arange(40, 52), np.array([3, 77, 90, 101])):
        for v in bnodes:
            adj.put(int(v), g.neighbors(int(v)), g.neighbor_weights(int(v)),
                    float(g.node_w[v]))
        out.append(micro.commit(bnodes.astype(np.int64)))
    v = int(np.argmax(np.diff(g.indptr)))
    adj.put(v, g.neighbors(v), g.neighbor_weights(v), 1.0)
    out.append(micro.commit_hub(v, 1.0))
    return out, micro.log, adj.resident_bytes


@pytest.mark.parametrize("engine", ["sparse", "torch"])
def test_micro_restreamer_equals_reference(engine, base_graph):
    cfg, ref_cfg = _cfg(engine), _ref_cfg()
    b0, s0 = ref_partition(base_graph, ref_cfg)
    loads = np.bincount(b0, minlength=4).astype(np.float64)
    got_block, want_block = b0.copy(), b0.copy()
    got_loads, want_loads = loads.copy(), loads.copy()
    cm, ref_cm = IncrementalCut(s0.cut_weight), RefIncrementalCut(s0.cut_weight)
    got = _micro_case(_port(base_graph), MicroRestreamer, AdjacencyCache, FennelParams, cfg,
                      got_block, got_loads, cm)
    want = _micro_case(base_graph, RefMicroRestreamer, RefAdjacencyCache, RefFennelParams,
                       ref_cfg, want_block, want_loads, ref_cm)
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    assert got[1] == {k: v for k, v in want[1].items() if k != "engine_fallbacks"}
    assert "engine_fallbacks" not in got[1] and got[2] == want[2] == 0
    np.testing.assert_array_equal(got_block, want_block)
    np.testing.assert_array_equal(got_loads, want_loads)
    assert cm.cut_weight == ref_cm.cut_weight == edge_cut(_port(base_graph), got_block)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_device_error_inside_commit_propagates(prefetch, base_graph, disk_files, monkeypatch):
    """No host fallback: the batch's engine error reaches the caller and no
    pump thread is left behind."""
    cfg = _cfg("torch")
    b0, s0 = buffcut_partition(_port(base_graph), cfg)

    def lost_card(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(port_restream, "multilevel_partition", lost_card)
    for order in ("stream", "priority"):
        with pytest.raises(RuntimeError, match="illegal memory access"):
            restream_refine(DiskNodeStream(disk_files["natural"]), b0, cfg, 1, order=order,
                            initial_cut=s0.cut_weight, prefetch_batches=prefetch)
    assert not [t for t in threading.enumerate() if t.name == "prefetch-pump" and t.is_alive()]


# ----------------------------------------------------------------- resume


@pytest.mark.parametrize("engine", ["sparse", "torch"])
@pytest.mark.parametrize("src", ["packed", "memory"])
@pytest.mark.parametrize("rorder", ["stream", "priority"])
def test_every_restream_snapshot_resumes_bit_identically(rorder, src, engine, base_graph,
                                                         disk_files, tmp_path):
    cfg = _cfg(engine)

    def source():
        return (DiskNodeStream(disk_files["konect"]) if src == "packed"
                else NodeStream(_port(R.apply_order(base_graph,
                                                    R.konect_order(base_graph, seed=1)))))

    b0, s0 = buffcut_partition(source(), cfg)
    seeds = dict(initial_cut=s0.cut_weight, initial_loads=np.asarray(s0.block_loads))
    want, winfo = restream_refine(source(), b0, cfg, 2, order=rorder, **seeds)
    real, copies = ckmod.save_checkpoint, []

    def tee(path, state):
        real(path, state)
        copies.append(str(tmp_path / f"{len(copies):03d}.ckpt"))
        shutil.copy(path, copies[-1])

    monkeypatch = pytest.MonkeyPatch()
    monkeypatch.setattr(ckmod, "save_checkpoint", tee)
    try:
        got, ginfo = restream_refine(source(), b0, cfg, 2, order=rorder,
                                     ckpt=Checkpointer(str(tmp_path / "run.ckpt"), every=2),
                                     **seeds)
    finally:
        monkeypatch.undo()
    np.testing.assert_array_equal(got, want)
    assert ginfo.cut_weight == winfo.cut_weight and len(copies) >= 3
    passes_seen = set()
    for snap in copies[:: max(1, len(copies) // 4)] + copies[-1:]:
        state = load_checkpoint(snap)
        assert state["kind"] == "restream"
        passes_seen.add(state["pass_idx"])
        res, rinfo = restream_refine(source(), b0, cfg, 2, order=rorder, resume=state)
        np.testing.assert_array_equal(res, want, err_msg=os.path.basename(snap))
        assert rinfo.cut_weight == winfo.cut_weight and rinfo.passes == winfo.passes
    assert passes_seen == {0, 1}


def test_restream_resume_rejects_another_order(base_graph, disk_files, tmp_path):
    cfg = _cfg()
    b0, _ = buffcut_partition(DiskNodeStream(disk_files["natural"]), cfg)
    p = str(tmp_path / "c.ckpt")
    restream_refine(DiskNodeStream(disk_files["natural"]), b0, cfg, 1, order="stream",
                    ckpt=Checkpointer(p, every=2))
    from repro_torch.core import CheckpointError

    with pytest.raises(CheckpointError, match="config does not match"):
        restream_refine(DiskNodeStream(disk_files["natural"]), b0, cfg, 1, order="priority",
                        resume=load_checkpoint(p))



if __name__ == "__main__":
    # the same comparison at a larger mesh, with the pass logs printed:
    # PYTHONPATH=src python tests/test_torch_restream.py 512
    import sys
    import tempfile
    import time

    side = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        for order, log in _restream_at_full_width_ratios(side, f"{tmp}/grid.bcsr").items():
            rise = log["cut_after"] / log["cut_before"] - 1
            print(f"grid {side}, {order} order: cut {log['cut_before']:.0f} -> "
                  f"{log['cut_after']:.0f} ({rise:+.4%}), moved {log['moved']}, equal in "
                  f"both packages")
        print(f"{time.perf_counter() - t0:.1f} s")
