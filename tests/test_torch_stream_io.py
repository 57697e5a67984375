"""repro_torch's out-of-core stream substrate against repro's: packed and
METIS files written by one package are byte-identical to the other's and
read back equal; the chunked parsers, resume tokens, ELL chunks and graph
builders match the reference's; and the three drivers cannot tell a disk
stream from the in-memory graph — bit-identical labels and StreamStats on
the host `sparse` and the device `torch` engine (device "cpu"), under
natural, BFS and KONECT orders realised on disk by `permute_to_disk`."""
import dataclasses
import filecmp
import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.graphs as R
from repro.core.buffcut import BuffCutConfig as RefBuffCutConfig
from repro.core.buffcut import _buffcut_partition as ref_partition
from repro.core.multilevel import MultilevelConfig as RefMultilevelConfig
from repro.graphs.stream_io import MetisChunkReader as RefMetisChunkReader
import repro_torch.graphs as P
from repro_torch.convert import graph_from_numpy
from repro_torch.core import (
    BuffCutConfig,
    MultilevelConfig,
    PipelineConfig,
    VectorizedConfig,
    buffcut_partition,
    buffcut_partition_pipelined,
    buffcut_partition_vectorized,
    edge_cut,
)
from repro_torch.graphs.stream_io import MetisChunkReader, read_packed_header


def _port(g):
    return graph_from_numpy(g.indptr, g.indices, g.edge_w, g.node_w)


def _same_graph(a, b):
    for f in ("indptr", "indices", "edge_w", "node_w"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def _weighted(seed=3, n=96):
    rng = np.random.default_rng(seed)
    g = R.rmat_graph(n, 5, seed=11)
    e = g.to_edge_list()
    return R.CSRGraph.from_edges(
        g.n, e,
        edge_weights=rng.integers(1, 6, e.shape[0]).astype(np.float32),
        node_weights=rng.integers(1, 4, g.n).astype(np.float32),
    )


def _fractional():
    return R.CSRGraph.from_edges(
        4, np.array([[0, 1], [1, 2], [0, 2]]),
        edge_weights=np.array([2.5, 3.0, 0.1], dtype=np.float32),
        node_weights=np.array([1.5, 2.0, 3.25, 1.0], dtype=np.float32),
    )


GRAPHS = {
    "rmat": lambda: R.rmat_graph(128, 5, seed=7),
    "weighted": _weighted,
    "fractional": _fractional,
    "node_weights_only": lambda: R.CSRGraph.from_edges(
        5, np.array([[0, 1], [1, 2]]), node_weights=np.array([1, 2, 3, 4, 5], np.float32)),
    "isolated": lambda: R.CSRGraph.from_edges(5, np.array([[0, 1]])),
}


# ---------------------------------------------------------- byte identity


@pytest.mark.parametrize("section_records", [1, 7, 4096])
@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_packed_files_are_byte_identical_and_cross_read(name, version, section_records,
                                                        tmp_path):
    g = GRAPHS[name]()
    ref_path, port_path = str(tmp_path / "r.bcsr"), str(tmp_path / "p.bcsr")
    R.write_packed(g, ref_path, version=version, section_records=section_records)
    P.write_packed(_port(g), port_path, version=version, section_records=section_records)
    assert filecmp.cmp(ref_path, port_path, shallow=False)
    _same_graph(P.read_packed(ref_path), g)
    _same_graph(R.read_packed(port_path), g)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_metis_files_are_byte_identical_and_cross_read(name, tmp_path):
    g = GRAPHS[name]()
    ref_path, port_path = str(tmp_path / "r.metis"), str(tmp_path / "p.metis")
    R.write_metis(g, ref_path)
    P.write_metis(_port(g), port_path)
    assert filecmp.cmp(ref_path, port_path, shallow=False)
    _same_graph(P.read_metis(ref_path), g)
    _same_graph(R.read_metis(port_path), g)


DISK_WRITERS = {
    "grid": (lambda m, p: m.grid_mesh_to_disk(17, p), lambda m: m.grid_mesh_graph(17)),
    "grid_nodiag": (lambda m, p: m.grid_mesh_to_disk(9, p, diag=False),
                    lambda m: m.grid_mesh_graph(9, diag=False)),
    "ring": (lambda m, p: m.ring_to_disk(50, p), lambda m: m.ring_graph(50)),
    "gen_grid": (lambda m, p: m.generate_to_disk("grid", p, side=12),
                 lambda m: m.grid_mesh_graph(12)),
    "gen_ring": (lambda m, p: m.generate_to_disk("ring", p, n=33), lambda m: m.ring_graph(33)),
    "gen_rmat": (lambda m, p: m.generate_to_disk("rmat", p, n=64, avg_degree=6, seed=2),
                 lambda m: m.rmat_graph(64, 6, seed=2)),
    "gen_rgg": (lambda m, p: m.generate_to_disk("rgg", p, n=150, seed=4),
                lambda m: m.rgg_graph(150, seed=4)),
    "gen_rhg": (lambda m, p: m.generate_to_disk("rhg", p, n=150, avg_degree=6, seed=4),
                lambda m: m.rhg_like_graph(150, 6, seed=4)),
    "gen_sbm": (lambda m, p: m.generate_to_disk("sbm", p, n=80, n_blocks=4, seed=1),
                lambda m: m.sbm_graph(80, 4, seed=1)),
    "gen_star": (lambda m, p: m.generate_to_disk("star", p, n=40), lambda m: m.star_graph(40)),
}


@pytest.mark.parametrize("name", sorted(DISK_WRITERS))
def test_disk_writers_are_byte_identical_and_stream_the_graph(name, tmp_path):
    write, build = DISK_WRITERS[name]
    ref_path, port_path = str(tmp_path / "r.bcsr"), str(tmp_path / "p.bcsr")
    assert write(R, ref_path) == write(P, port_path)
    assert filecmp.cmp(ref_path, port_path, shallow=False)
    _same_graph(P.read_packed(port_path), build(P))
    _same_graph(build(P), build(R))


def test_generate_to_disk_rejects_unknown_family(tmp_path):
    with pytest.raises(ValueError, match="unknown family"):
        P.generate_to_disk("nope", str(tmp_path / "x.bcsr"))


@pytest.mark.parametrize("shard_nodes", [1, 37, 1 << 14])
@pytest.mark.parametrize("order", ["bfs", "konect", "random"])
def test_permute_to_disk_is_byte_identical_and_realises_apply_order(order, shard_nodes,
                                                                    tmp_path):
    g = _weighted()
    perm = {"bfs": R.bfs_order(g), "konect": R.konect_order(g, seed=1),
            "random": R.random_order(g, 5)}[order]
    src = str(tmp_path / "g.bcsr")
    R.write_packed(g, src)
    ref_out, port_out = str(tmp_path / "r.bcsr"), str(tmp_path / "p.bcsr")
    R.permute_to_disk(src, perm, ref_out, shard_nodes=shard_nodes)
    P.permute_to_disk(src, perm, port_out, shard_nodes=shard_nodes)
    assert filecmp.cmp(ref_out, port_out, shallow=False)
    _same_graph(P.read_packed(port_out), P.apply_order(_port(g), perm))
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]


def test_permute_rejects_bad_perm(tmp_path):
    src = str(tmp_path / "g.bcsr")
    P.write_packed(P.CSRGraph.from_edges(4, np.array([[0, 1]])), src)
    with pytest.raises(ValueError, match="perm has"):
        P.permute_to_disk(src, np.arange(3), str(tmp_path / "o.bcsr"))


# ----------------------------------------------------------- the parsers


@st.composite
def weighted_graphs(draw):
    """Small simple graphs covering all four METIS fmt variants."""
    n = draw(st.integers(4, 24))
    n_e = draw(st.integers(0, 40))
    edges = np.array(draw(st.lists(st.tuples(st.integers(0, n - 1), st.integers(0, n - 1)),
                                   min_size=n_e, max_size=n_e)), dtype=np.int64).reshape(-1, 2)
    ew = nw = None
    if draw(st.integers(0, 1)):
        ew = np.array(draw(st.lists(st.integers(2, 9), min_size=edges.shape[0],
                                    max_size=edges.shape[0])), dtype=np.float32)
    if draw(st.integers(0, 1)):
        nw = np.array(draw(st.lists(st.integers(2, 5), min_size=n, max_size=n)),
                      dtype=np.float32)
    return P.CSRGraph.from_edges(n, edges, edge_weights=ew, node_weights=nw)


def _records_equal(a, b):
    assert len(a) == len(b)
    for (n1, w1, nw1), (n2, w2, nw2) in zip(a, b):
        np.testing.assert_array_equal(n1, n2)
        np.testing.assert_array_equal(w1, w2)
        assert nw1 == nw2


@given(weighted_graphs(), st.integers(1, 80))
@settings(max_examples=25, deadline=None)
def test_chunk_boundary_invariance_and_reference_parse(tmp_path_factory, g, chunk_bytes):
    """Any chunk-boundary placement gives the whole-file parse, and the
    reference's parser reads the same records from the port's file."""
    path = str(tmp_path_factory.mktemp("cb") / "g.metis")
    P.write_metis(g, path)
    whole = list(MetisChunkReader(path, 1 << 20).records())
    _records_equal(list(MetisChunkReader(path, chunk_bytes).records()), whole)
    _records_equal(list(RefMetisChunkReader(path, chunk_bytes).records()), whole)


@given(weighted_graphs(), st.integers(64, 512))
@settings(max_examples=20, deadline=None)
def test_packed_roundtrip_and_canonical_totals(tmp_path_factory, g, io_chunk):
    path = str(tmp_path_factory.mktemp("pk") / "g.bcsr")
    P.write_packed(g, path)
    _same_graph(P.read_packed(path, io_chunk_bytes=io_chunk), g)
    ms, ds = P.NodeStream(g), P.DiskNodeStream(path, io_chunk_bytes=io_chunk)
    assert (ms.n_total, ms.m_total) == (ds.n_total, ds.m_total)
    rs = R.DiskNodeStream(path)
    assert (rs.n_total, rs.m_total) == (ds.n_total, ds.m_total)


def test_trailing_whitespace_and_comments(tmp_path):
    path = str(tmp_path / "g.metis")
    with open(path, "w") as f:
        f.write("% a comment\n4 3  \t\n2 3\t \n% mid comment\n1\r\n1 4\n3   \n\n\n")
    g = P.read_metis(path)
    assert g.n == 4 and g.m == 3
    assert list(g.neighbors(0)) == [1, 2]
    _same_graph(g, R.read_metis(path))
    for cb in (1, 5, 13):
        _records_equal(list(MetisChunkReader(path, cb).records()),
                       list(MetisChunkReader(path).records()))


@pytest.mark.parametrize("content, match", [
    ("", "missing METIS header"),
    ("% only comments\n", "missing METIS header"),
    ("5\n", "header must be"),
    ("4 3 11 2 9\n", "header must be"),
    ("a b\n", "non-integer"),
    ("4 3 7\n", "unsupported METIS fmt"),
    ("4 3 011\n", "unsupported METIS fmt"),
    ("-4 3\n", "negative"),
    ("2 1\n2\n1\n2\n", "trailing data"),
    ("3 1\n2\n1\n", "expected 3 node lines"),
    ("2 2\n2\n1\n", "header m=2"),
    ("2 1\n3\n1\n", "out of range"),
    ("2 1 10\n\n1 1\n", "missing node weight"),
    ("2 1 10\nx 2\n1 1\n", "bad node weight"),
    ("2 1 1\n2\n1 1\n", "odd token count"),
    ("2 1\n2\nz\n", "non-numeric"),
])
def test_malformed_metis_raises_like_the_reference(tmp_path, content, match):
    path = str(tmp_path / "bad.metis")
    with open(path, "w") as f:
        f.write(content)
    with pytest.raises(P.StreamFormatError, match=match):
        P.read_metis(path)
    with pytest.raises(R.StreamFormatError, match=match):
        R.read_metis(path)


def test_packed_bad_magic_and_truncation(tmp_path):
    bad = str(tmp_path / "bad.bcsr")
    with open(bad, "wb") as f:
        f.write(b"NOPE" + b"\x00" * 60)
    with pytest.raises(P.StreamFormatError, match="bad magic"):
        P.read_packed(bad)
    path = str(tmp_path / "t.bcsr")
    P.write_packed(P.CSRGraph.from_edges(6, np.array([[0, 1], [1, 2], [2, 3], [3, 4],
                                                      [4, 5]])), path)
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[:-6])
    with pytest.raises(P.StreamFormatError, match="truncated"):
        P.read_packed(path)


def test_packed_header_crc_and_legacy_header(tmp_path):
    path = str(tmp_path / "g.bcsr")
    P.write_packed(_port(_weighted()), path)
    raw = bytearray(open(path, "rb").read())
    good = raw[:]
    raw[40] ^= 0x01  # inside m_total
    open(path, "wb").write(bytes(raw))
    with pytest.raises(P.StreamFormatError, match="header CRC"):
        read_packed_header(path)
    good[44:48] = b"\x00\x00\x00\x00"  # a v2 file from before the header CRC
    open(path, "wb").write(bytes(good))
    assert read_packed_header(path)["n"] == _weighted().n


def test_open_stream_detects_format(tmp_path):
    g = P.CSRGraph.from_edges(5, np.array([[0, 1], [1, 2]]))
    pm, pb = str(tmp_path / "g.metis"), str(tmp_path / "g.bcsr")
    P.write_metis(g, pm)
    P.write_packed(g, pb)
    assert P.open_stream(pm).n == P.open_stream(pb).n == 5
    assert not P.open_stream(pm).crc_protected and P.open_stream(pb).crc_protected
    for (v1, n1, _, _), (v2, n2, _, _) in zip(P.open_stream(pm), P.open_stream(pb)):
        assert v1 == v2 and np.array_equal(n1, n2)


def test_stream_resident_bytes_bounded(tmp_path):
    path = str(tmp_path / "grid.bcsr")
    P.grid_mesh_to_disk(32, path)
    stream = P.DiskNodeStream(path, io_chunk_bytes=512)
    peak = 0
    for _ in stream:
        peak = max(peak, stream.resident_bytes)
    assert 0 < peak <= 2 * 512 + 256
    assert stream.bytes_read >= 0.9 * os.path.getsize(path)


@pytest.mark.parametrize("io_chunk", [64, 333, 1 << 20])
@pytest.mark.parametrize("fmt", ["packed_v2_s5", "packed_v2", "packed_v1", "metis"])
def test_resume_tokens_equal_the_reference_and_resume_the_tail(fmt, io_chunk, tmp_path):
    g = _weighted()
    path = str(tmp_path / "g.graph")
    if fmt == "metis":
        R.write_metis(g, path)
    else:
        R.write_packed(g, path, version=1 if fmt == "packed_v1" else 2,
                       section_records=5 if fmt.endswith("s5") else 4096)
    port, ref = P.DiskNodeStream(path, io_chunk), R.DiskNodeStream(path, io_chunk)
    assert port.tell() == ref.tell()
    toks, recs = [], []
    for (v, nb, w, nw), rrec in zip(port, ref):
        assert port.tell() == ref.tell()
        assert v == rrec[0] and np.array_equal(nb, rrec[1]) and np.array_equal(w, rrec[2])
        toks.append(port.tell())
        recs.append((v, nb.copy(), w.copy(), nw))
    assert port.bytes_read == ref.bytes_read and port.io_retries == 0
    for i in (0, 1, len(recs) // 3, len(recs) - 2):
        tail = list(P.DiskNodeStream(path, io_chunk).iter_from(toks[i]))
        assert [r[0] for r in tail] == [r[0] for r in recs[i + 1:]]
        for a, b in zip(tail, recs[i + 1:]):
            assert np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2]) and a[3] == b[3]


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_chunks_match_memory_and_reference(chunk, tmp_path):
    g = _weighted()
    path = str(tmp_path / "g.bcsr")
    R.write_packed(g, path)
    disk = list(P.DiskNodeStream(path).chunks(chunk))
    mem = list(P.NodeStream(_port(g)).chunks(chunk))
    ref_disk = list(R.DiskNodeStream(path).chunks(chunk))
    ref_mem = list(R.NodeStream(g).chunks(chunk))
    assert len(disk) == len(mem) == len(ref_disk) == len(ref_mem) == -(-g.n // chunk)
    for a, b, c, d in zip(disk, mem, ref_disk, ref_mem):
        assert set(a) == set(b) == {"nodes", "nbr", "nbr_w", "mask", "node_w"}
        for key in a:
            for other in (b, c, d):
                np.testing.assert_array_equal(a[key], other[key])


def test_stream_weight_flags_match_reference():
    for name, build in GRAPHS.items():
        g = build()
        port, ref = P.NodeStream(_port(g)), R.NodeStream(g)
        assert (port.has_edge_w, port.has_node_w) == (ref.has_edge_w, ref.has_node_w), name


def test_node_stream_reads_no_bytes_and_retries_nothing():
    g = R.rmat_graph(64, 4, seed=2)
    s = P.NodeStream(_port(g))
    assert sum(1 for _ in s) == g.n
    assert s.io_retries == 0 and s.bytes_read == 0 and s.resident_bytes == 0


def test_validate_accepts_graphs_and_catches_self_loops():
    for name, build in GRAPHS.items():
        _port(build()).validate()
    bad = P.CSRGraph(indptr=np.array([0, 1, 2]), indices=np.array([0, 0], np.int32),
                     edge_w=np.ones(2, np.float32), node_w=np.ones(2, np.float32))
    with pytest.raises(AssertionError, match="self loop"):
        bad.validate()


@pytest.mark.parametrize("family", ["rgg", "rhg", "star", "ring"])
def test_builders_equal_the_reference(family):
    build = {"rgg": lambda m: m.rgg_graph(300, seed=3),
             "rhg": lambda m: m.rhg_like_graph(300, 6, seed=3),
             "star": lambda m: m.star_graph(30), "ring": lambda m: m.ring_graph(30)}[family]
    _same_graph(build(P), build(R))


# -------------------------------------------- disk == memory, 3 drivers


def _vec(s, cfg):
    return buffcut_partition_vectorized(s, cfg, VectorizedConfig(wave=1, chunk=1))


DRIVERS = {
    "sequential": buffcut_partition,
    "vectorized": _vec,
    "pipelined": buffcut_partition_pipelined,
}
ORDERINGS = {"natural": None, "bfs": R.bfs_order, "konect": lambda g: R.konect_order(g, seed=1)}


@pytest.fixture(scope="module")
def base_graph():
    return R.rmat_graph(128, 5, seed=7)


@pytest.fixture(scope="module")
def disk_files(base_graph, tmp_path_factory):
    """The natural-order packed file, written by the port, and each
    ordering realised on disk by the port's permute pass."""
    tmp = tmp_path_factory.mktemp("torch-conformance")
    natural = str(tmp / "g.bcsr")
    P.write_packed(_port(base_graph), natural)
    paths = {"natural": natural}
    for name, fn in ORDERINGS.items():
        if fn is not None:
            paths[name] = str(tmp / f"g_{name}.bcsr")
            P.permute_to_disk(natural, fn(base_graph), paths[name], shard_nodes=37)
    return paths


def _cfg(engine: str) -> BuffCutConfig:
    return BuffCutConfig(k=4, buffer_size=24, batch_size=12, d_max=48, score="haa",
                         collect_stats=True, ml=MultilevelConfig(engine=engine, device="cpu"))


def _ref_cfg() -> RefBuffCutConfig:
    return RefBuffCutConfig(k=4, buffer_size=24, batch_size=12, d_max=48, score="haa",
                            collect_stats=True, ml=RefMultilevelConfig(engine="sparse"))


def _memory_graph(base_graph, order: str):
    fn = ORDERINGS[order]
    return base_graph if fn is None else R.apply_order(base_graph, fn(base_graph))


def _assert_stats_equal(a, b):
    assert (a.cut_weight, a.balance, a.n_batches, a.n_hubs) == (
        b.cut_weight, b.balance, b.n_batches, b.n_hubs)
    assert a.ier_per_batch == b.ier_per_batch


@pytest.mark.parametrize("order", sorted(ORDERINGS))
@pytest.mark.parametrize("engine", ["sparse", "torch"])
@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_disk_matches_memory_and_reference(driver, engine, order, base_graph, disk_files):
    cfg = _cfg(engine)
    gm = _memory_graph(base_graph, order)
    b_mem, s_mem = DRIVERS[driver](_port(gm), cfg)
    disk = P.DiskNodeStream(disk_files[order])
    b_disk, s_disk = DRIVERS[driver](disk, cfg)
    np.testing.assert_array_equal(b_mem, b_disk)
    _assert_stats_equal(s_disk, s_mem)
    assert s_disk.cut_weight == edge_cut(_port(gm), b_disk)
    assert s_disk.stream_bytes_read >= os.path.getsize(disk_files[order]) - 64
    assert s_mem.stream_bytes_read == 0 and s_disk.io_retries == 0
    # the reference's sequential driver on the same graph in memory
    b_ref, s_ref = ref_partition(gm, _ref_cfg())
    np.testing.assert_array_equal(b_disk, b_ref)
    assert s_disk.cut_weight == s_ref.cut_weight


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_metis_text_backend_matches_packed(driver, base_graph, disk_files, tmp_path):
    cfg = _cfg("sparse")
    p_txt = str(tmp_path / "g.metis")
    P.write_metis(_port(base_graph), p_txt)
    b_txt, s_txt = DRIVERS[driver](P.DiskNodeStream(p_txt, io_chunk_bytes=97), cfg)
    b_bin, s_bin = DRIVERS[driver](P.DiskNodeStream(disk_files["natural"]), cfg)
    np.testing.assert_array_equal(b_txt, b_bin)
    assert (s_txt.cut_weight, s_txt.balance) == (s_bin.cut_weight, s_bin.balance)


@pytest.mark.parametrize("engine", ["sparse", "torch"])
def test_weighted_disk_matches_memory(engine, tmp_path):
    g = _weighted()
    p = str(tmp_path / "w.bcsr")
    P.write_packed(_port(g), p)
    cfg = _cfg(engine)
    b_mem, s_mem = buffcut_partition(_port(g), cfg)
    b_disk, s_disk = buffcut_partition(P.DiskNodeStream(p), cfg)
    np.testing.assert_array_equal(b_mem, b_disk)
    assert (s_mem.cut_weight, s_mem.balance) == (s_disk.cut_weight, s_disk.balance)


@pytest.mark.parametrize("prefetch", [1, 2])
@pytest.mark.parametrize("driver", ["sequential", "vectorized"])
def test_prefetched_disk_stream_matches_unprefetched(driver, prefetch, disk_files):
    cfg = _cfg("sparse")
    run = {"sequential": lambda s, **kw: buffcut_partition(s, cfg, **kw),
           "vectorized": lambda s, **kw: buffcut_partition_vectorized(
               s, cfg, VectorizedConfig(wave=1, chunk=1), **kw)}[driver]
    want, ws = run(P.DiskNodeStream(disk_files["bfs"]))
    got, gs = run(P.DiskNodeStream(disk_files["bfs"]), prefetch_batches=prefetch)
    np.testing.assert_array_equal(got, want)
    assert (gs.cut_weight, gs.stream_bytes_read) == (ws.cut_weight, ws.stream_bytes_read)


# ------------------------------------------------------- memory ceiling


def _resident_bound(stream, cfg, max_deg: int, pipe: PipelineConfig | None = None) -> int:
    """buffer + batch + read-ahead, in bytes, as the reference's
    conformance suite bounds it.  The pipelined driver adds its staging:
    the prefetch pump's blocks (int32 ids + float32 weights + 64 bytes a
    record) and the batch payloads queued for or held by T3."""
    per_node = max_deg * 16 + 96
    retained = (cfg.buffer_size + 2 * cfg.batch_size + 2) * per_node
    read_ahead = 2 * stream.io_chunk_bytes + per_node
    staged = 0
    if pipe is not None:
        staged = ((pipe.prefetch_batches + 1) * cfg.batch_size * (max_deg * 8 + 64)
                  + (pipe.queue_depth + 1) * cfg.batch_size * per_node)
    return retained + read_ahead + staged


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_memory_ceiling_on_4x_graph(driver, tmp_path):
    path = str(tmp_path / "grid.bcsr")
    P.grid_mesh_to_disk(64, path)  # n = 4096 nodes
    cfg = BuffCutConfig(k=4, buffer_size=256, batch_size=128, d_max=64,
                        ml=MultilevelConfig(engine="sparse", device="cpu"))
    stream = P.DiskNodeStream(path, io_chunk_bytes=1 << 12)
    assert stream.n >= 4 * cfg.buffer_size
    block, stats = DRIVERS[driver](stream, cfg)
    assert (block >= 0).all()
    bound = _resident_bound(stream, cfg, 8, PipelineConfig() if driver == "pipelined" else None)
    assert stats.peak_resident_bytes <= bound, (stats.peak_resident_bytes, bound)
    assert stats.peak_resident_bytes < 0.5 * os.path.getsize(path) * 4
    assert stats.stream_bytes_read >= os.path.getsize(path) - 64


def test_pipelined_depths_keep_labels_on_disk(disk_files):
    cfg = _cfg("sparse")
    want, _ = buffcut_partition(P.DiskNodeStream(disk_files["konect"]), cfg)
    for q, pf in ((1, 0), (2, 1), (4, 3)):
        got, _ = buffcut_partition_pipelined(P.DiskNodeStream(disk_files["konect"]), cfg,
                                             PipelineConfig(queue_depth=q, prefetch_batches=pf))
        np.testing.assert_array_equal(got, want)


def test_port_config_carries_the_device(base_graph):
    cfg = _cfg("torch")
    assert dataclasses.asdict(cfg.ml)["device"] == "cpu"
    assert BuffCutConfig.from_json(cfg.to_json()) == cfg
