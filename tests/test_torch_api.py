"""repro_torch.api (the front door) against repro.api, on the same seeded
graphs: the legacy shims bit-identical to the API across drivers ×
engines (`sparse`, `torch` on the CPU) × sources (graph, METIS text,
packed), all seven registry names equal to the reference's labels,
aliases and custom registration, orderings in input numbering (random on
disk equal to memory), the restream post-pass, memory-only drivers on disk
streams and `--materialize`, config validation and JSON round trips, the
`PartitionResult` JSON equal to the reference's apart from provenance,
`resume` through the API, the `python -m repro_torch` CLI in-process
(`gen` files byte-identical to `python -m repro gen`), and a card request
with no card raising."""
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

import repro.api as RA
import repro.core as RC
import repro.graphs as RG
import repro_torch.core.checkpoint as ckmod
from repro.api.cli import main as ref_cli_main
from repro_torch.api import (
    CheckpointError,
    DriverConfig,
    PartitionResult,
    PartitionerSpec,
    list_partitioners,
    partition,
    register_partitioner,
    resolve_source,
    resume,
)
from repro_torch.api import registry as registry_mod
from repro_torch.api.cli import main as cli_main
from repro_torch.convert import graph_from_numpy
from repro_torch.core import (
    BuffCutConfig,
    CuttanaConfig,
    MultilevelConfig,
    PipelineConfig,
    VectorizedConfig,
    buffcut_partition,
    buffcut_partition_pipelined,
    buffcut_partition_vectorized,
    heistream_partition,
)
from repro_torch.graphs import DiskNodeStream, NodeStream, apply_order, bfs_order

ALL_NAMES = (
    "buffcut", "buffcut-vec", "buffcut-pipe", "heistream", "cuttana", "fennel", "ldg",
)

LEGACY = {
    "buffcut": lambda s, cfg: buffcut_partition(s, cfg),
    "buffcut-vec": lambda s, cfg: buffcut_partition_vectorized(s, cfg, VectorizedConfig()),
    "buffcut-pipe": lambda s, cfg: buffcut_partition_pipelined(s, cfg),
}
# timings, fields one package has and the other does not, and the peak
# residency: the API reads ahead with the prefetch pump (prefetch_batches=2
# by default), whose staged blocks at any moment depend on its thread's
# schedule
_STATS_DROP = {"runtime_s", "ml_time_s", "engine_fallbacks", "t3_wait_s",
               "peak_resident_bytes"}


def _port(g):
    return graph_from_numpy(g.indptr, g.indices, g.edge_w, g.node_w)


@pytest.fixture(scope="module")
def ref_graph():
    return RG.rmat_graph(128, 5, seed=7)


@pytest.fixture(scope="module")
def base_graph(ref_graph):
    return _port(ref_graph)


@pytest.fixture(scope="module")
def files(ref_graph, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch-api")
    packed = str(tmp / "g.bcsr")
    RG.write_packed(ref_graph, packed)
    metis = str(tmp / "g.metis")
    RG.write_metis(ref_graph, metis)
    return {"binary": packed, "text": metis}


def _cfg(engine: str = "sparse") -> BuffCutConfig:
    return BuffCutConfig(k=4, buffer_size=24, batch_size=12, d_max=48, score="haa",
                         collect_stats=True, ml=MultilevelConfig(engine=engine, device="cpu"))


def _ref_cfg() -> RC.BuffCutConfig:
    return RC.BuffCutConfig(k=4, buffer_size=24, batch_size=12, d_max=48, score="haa",
                            collect_stats=True, ml=RC.MultilevelConfig(engine="sparse"))


def _source(kind: str, base_graph, files):
    return base_graph if kind == "graph" else DiskNodeStream(files[kind])


def _ref_source(kind: str, ref_graph, files):
    return ref_graph if kind == "graph" else RG.DiskNodeStream(files[kind])


def _stats_equal(a, b) -> None:
    da = {k: v for k, v in a.to_dict().items() if k not in _STATS_DROP}
    db = {k: v for k, v in b.to_dict().items() if k not in _STATS_DROP}
    assert da == db


# ---------------------------------------------------- shim == API identity


@pytest.mark.parametrize("source_kind", ["graph", "text", "binary"])
@pytest.mark.parametrize("engine", ["sparse", "torch"])
@pytest.mark.parametrize("driver", sorted(LEGACY))
def test_legacy_shim_bit_identical_to_api(driver, engine, source_kind, base_graph, ref_graph,
                                          files):
    """The deprecation shims and the API give the same labels, bit for bit,
    on every driver × engine × source kind, and the reference's API the
    same again."""
    cfg = _cfg(engine)
    with pytest.warns(DeprecationWarning, match="repro_torch.api.partition"):
        legacy, _ = LEGACY[driver](_source(source_kind, base_graph, files), cfg)
    res = partition(_source(source_kind, base_graph, files),
                    DriverConfig(driver=driver, buffcut=cfg))
    assert res.provenance["driver"] == driver
    assert np.array_equal(legacy, res.labels)
    want = RA.partition(_ref_source(source_kind, ref_graph, files),
                        RA.DriverConfig(driver=driver, buffcut=_ref_cfg()))
    assert np.array_equal(res.labels, want.labels)


def test_vectorized_config_folds_into_api(base_graph):
    """A VectorizedConfig on the shim and the flat wave/chunk keys on the
    API are the same path."""
    cfg = _cfg()
    with pytest.warns(DeprecationWarning):
        legacy, _ = buffcut_partition_vectorized(base_graph, cfg,
                                                 VectorizedConfig(wave=4, chunk=8))
    res = partition(base_graph, cfg, driver="buffcut-vec", wave=4, chunk=8)
    assert np.array_equal(legacy, res.labels)


def test_api_path_does_not_warn(base_graph):
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        for name in ALL_NAMES:
            partition(base_graph, _cfg(), driver=name)


# ------------------------------------------------------------- registry


def test_registry_covers_all_seven():
    assert list(ALL_NAMES) == list_partitioners()[:7]
    assert set(ALL_NAMES) == set(RA.list_partitioners())


@pytest.mark.parametrize("engine", ["sparse", "torch"])
@pytest.mark.parametrize("name", ALL_NAMES)
def test_every_registered_name_matches_reference(name, engine, base_graph, ref_graph):
    """Each name yields a valid PartitionResult whose labels, metrics and
    stats equal the reference's (on its `sparse` engine)."""
    res = partition(base_graph, _cfg(engine), driver=name)
    want = RA.partition(ref_graph, _ref_cfg(), driver=name)
    assert isinstance(res, PartitionResult)
    assert res.labels.shape == (base_graph.n,)
    assert res.labels.min() >= 0 and res.labels.max() < res.k == 4
    np.testing.assert_array_equal(res.labels, want.labels)
    assert res.metrics() == want.metrics()
    assert (res.stats is None) == (want.stats is None)
    if res.stats is not None:
        _stats_equal(res.stats, want.stats)


def test_aliases_resolve():
    for alias, canonical in (
        ("sequential", "buffcut"),
        ("vectorized", "buffcut-vec"),
        ("pipelined", "buffcut-pipe"),
        ("buffcut-par", "buffcut-pipe"),
    ):
        assert registry_mod.get_partitioner(alias).name == canonical
        assert RA.get_partitioner(alias).name == canonical


def test_register_custom_partitioner(base_graph):
    spec = PartitionerSpec(
        name="api-test-zero",
        streaming=True,
        description="test-only",
        run=lambda src, dc: (np.zeros(src.stream.n, dtype=np.int64), None),
    )
    register_partitioner(spec)
    try:
        res = partition(base_graph, _cfg(), driver="api-test-zero")
        assert (res.labels == 0).all()
        with pytest.raises(ValueError, match="already registered"):
            register_partitioner(spec)
    finally:
        registry_mod._REGISTRY.pop("api-test-zero", None)


def test_overwrite_reclaims_alias(base_graph):
    """overwrite=True also reclaims names that were aliases, so the
    replacement resolves."""
    saved_registry = dict(registry_mod._REGISTRY)
    saved_aliases = dict(registry_mod._ALIASES)
    try:
        spec = PartitionerSpec(
            name="vectorized",  # an alias of buffcut-vec
            streaming=True,
            run=lambda src, dc: (np.ones(src.stream.n, dtype=np.int64), None),
        )
        register_partitioner(spec, overwrite=True)
        assert registry_mod.get_partitioner("vectorized") is spec
        res = partition(base_graph, _cfg(), driver="vectorized")
        assert (res.labels == 1).all()
    finally:
        registry_mod._REGISTRY.clear()
        registry_mod._REGISTRY.update(saved_registry)
        registry_mod._ALIASES.clear()
        registry_mod._ALIASES.update(saved_aliases)


def test_unknown_driver_names_the_registry(base_graph):
    with pytest.raises(KeyError, match="buffcut"):
        partition(base_graph, _cfg(), driver="does-not-exist")


@pytest.mark.parametrize("order", ["stream", "priority"])
def test_restream_post_pass_matches_reference(order, base_graph, ref_graph):
    """restream_passes=N equals N manual restream() passes, and the
    reference's post-pass: labels, refreshed stats and the pass log."""
    from repro_torch.core import restream

    cfg = _cfg()
    r0 = partition(base_graph, cfg)
    r1 = partition(base_graph, cfg, restream_passes=1, restream_order=order)
    assert r1.provenance["restream_passes"] == 1
    assert np.array_equal(r1.labels, restream(base_graph, r0.labels, cfg, 1, order=order))
    r2 = partition(base_graph, cfg, restream_passes=2, restream_order=order)
    want = RA.partition(ref_graph, _ref_cfg(), restream_passes=2, restream_order=order)
    np.testing.assert_array_equal(r2.labels, want.labels)
    _stats_equal(r2.stats, want.stats)
    got_log, want_log = r2.provenance["restream"], want.provenance["restream"]
    for a, b in zip(got_log["passes"], want_log["passes"]):
        assert a["cut_after"] == b["cut_after"] and a["moved"] == b["moved"]


# ------------------------------------------------------- source resolution


class _ForeignStream:
    """A path-less, graph-less NodeStreamBase implementation (user code)."""

    def __new__(cls, g):
        from repro_torch.graphs import NodeStreamBase

        class Impl(NodeStreamBase):
            def __init__(self, g_):
                self._inner = NodeStream(g_)
                self.n, self.m = g_.n, g_.m
                self.has_edge_w = self._inner.has_edge_w
                self.has_node_w = self._inner.has_node_w

            @property
            def n_total(self):
                return self._inner.n_total

            @property
            def m_total(self):
                return self._inner.m_total

            def __iter__(self):
                return iter(self._inner)

        return Impl(g)


def test_resolve_source_kinds(base_graph, files):
    assert resolve_source(base_graph).kind == "graph"
    assert resolve_source(files["binary"]).kind == "packed"
    assert resolve_source(files["text"]).kind == "metis"
    assert resolve_source("gen:ring:n=16").kind == "generated"
    assert resolve_source(NodeStream(base_graph)).graph is base_graph
    ds = resolve_source(DiskNodeStream(files["binary"]))
    assert ds.kind == "stream" and ds.graph is None
    with pytest.raises(ValueError, match="family"):
        resolve_source("gen:nope:n=4")
    with pytest.raises(ValueError, match="key=value"):
        resolve_source("gen:ring:n")
    with pytest.raises(FileNotFoundError):
        resolve_source("no/such/file.bcsr")
    with pytest.raises(TypeError):
        resolve_source(42)


def test_generated_sources_equal_the_references():
    for spec in ("gen:grid:side=12", "gen:rmat:n=256,avg_degree=6,seed=3", "gen:ring:n=40",
                 "gen:star:n=30", "gen:sbm:n=96,n_blocks=4,p_in=0.2,p_out=0.01,seed=2",
                 "gen:rgg:n=128,seed=4", "gen:rhg:n=128,avg_degree=6,seed=1"):
        got, want = resolve_source(spec).graph, RA.resolve_source(spec).graph
        for name in ("indptr", "indices", "edge_w", "node_w"):
            assert getattr(got, name).tobytes() == getattr(want, name).tobytes(), (spec, name)


def test_foreign_stream_with_packed_path_materializes(base_graph, files):
    s = _ForeignStream(base_graph)
    s.path = files["binary"]
    src = resolve_source(s)
    assert src.kind == "stream" and src.path == files["binary"]
    g = src.materialize()
    assert np.array_equal(g.indptr, base_graph.indptr)
    assert np.array_equal(g.indices, base_graph.indices)


def test_all_source_kinds_agree(base_graph, files):
    cfg = _cfg()
    ref = partition(base_graph, cfg).labels
    for source in (
        files["text"],
        files["binary"],
        NodeStream(base_graph),
        DiskNodeStream(files["binary"]),
        "gen:rmat:n=128,avg_degree=5,seed=7",
    ):
        assert np.array_equal(ref, partition(source, cfg).labels), source


@pytest.mark.parametrize("name", ["heistream", "cuttana", "fennel", "ldg"])
def test_memory_only_rejects_disk_stream(name, files):
    with pytest.raises(TypeError, match="memory-only"):
        partition(files["binary"], _cfg(), driver=name)


@pytest.mark.parametrize("name", ["heistream", "cuttana", "fennel", "ldg"])
def test_materialize_unlocks_memory_only(name, base_graph, ref_graph, files):
    src = resolve_source(files["binary"])
    src.materialize()
    res = partition(src, _cfg(), driver=name)
    want = RA.partition(ref_graph, _ref_cfg(), driver=name)
    np.testing.assert_array_equal(res.labels, want.labels)
    if name == "heistream":
        with pytest.warns(DeprecationWarning):
            legacy, _ = heistream_partition(base_graph, _cfg())
        np.testing.assert_array_equal(res.labels, legacy)


def test_restream_on_disk_stream_matches_memory(base_graph, files):
    from repro_torch.core import balance as balance_metric, edge_cut

    cfg = _cfg()
    r_mem = partition(base_graph, cfg, restream_passes=2)
    r_disk = partition(files["binary"], cfg, restream_passes=2)
    assert np.array_equal(r_mem.labels, r_disk.labels)
    assert r_mem.stats.cut_weight == r_disk.stats.cut_weight
    assert r_mem.stats.balance == r_disk.stats.balance
    assert r_disk.stats.cut_weight == pytest.approx(edge_cut(base_graph, r_disk.labels))
    assert r_disk.stats.balance == pytest.approx(
        balance_metric(base_graph, r_disk.labels, r_disk.k))
    assert r_disk.graph is None
    assert r_disk.cut_weight == r_mem.cut_weight


def test_restream_order_knob_routes_and_validates():
    dc = DriverConfig.create(k=4, restream_passes=1, restream_order="priority")
    assert dc.restream_order == "priority"
    assert DriverConfig.from_json(dc.to_json()).restream_order == "priority"
    with pytest.raises(ValueError, match="restream_order"):
        DriverConfig.create(restream_order="bogus")


# ------------------------------------------------------------- orderings


@pytest.mark.parametrize("ordering", ["natural", "random", "bfs", "konect"])
def test_ordering_labels_in_input_numbering(ordering, base_graph, ref_graph):
    """Every ordering gives the reference's labels, mapped back to the
    input's node ids."""
    res = partition(base_graph, _cfg(), ordering=ordering, order_seed=3)
    want = RA.partition(ref_graph, _ref_cfg(), ordering=ordering, order_seed=3)
    np.testing.assert_array_equal(res.labels, want.labels)
    assert res.cut_weight == pytest.approx(res.stats.cut_weight)


def test_bfs_ordering_equals_manual_relabel(base_graph):
    cfg = _cfg()
    perm = bfs_order(base_graph)
    with pytest.warns(DeprecationWarning):
        ref, _ = buffcut_partition(apply_order(base_graph, perm), cfg)
    expected = np.empty_like(ref)
    expected[perm] = ref
    assert np.array_equal(partition(base_graph, cfg, ordering="bfs").labels, expected)


def test_ordering_on_pathless_stream_materializes(base_graph):
    cfg = _cfg()
    ref = partition(base_graph, cfg, ordering="random", order_seed=5)
    res = partition(_ForeignStream(base_graph), cfg, ordering="random", order_seed=5)
    assert np.array_equal(ref.labels, res.labels)


def test_ordering_preserves_io_chunk(files):
    from repro_torch.api import _realize_ordering

    src = resolve_source(DiskNodeStream(files["binary"], io_chunk_bytes=4096))
    dc = DriverConfig.create(k=4, ordering="random", order_seed=1)
    run_src, perm, tmp = _realize_ordering(src, dc)
    try:
        assert run_src.stream.io_chunk_bytes == 4096
    finally:
        tmp.cleanup()


@pytest.mark.parametrize("driver", ["buffcut", "buffcut-pipe"])
def test_disk_random_ordering_matches_memory(driver, base_graph, files):
    """Disk sources realize orderings via the on-disk permute pass and stay
    bit-identical to the in-memory apply_order path."""
    cfg = _cfg()
    a = partition(files["binary"], cfg, driver=driver, ordering="random", order_seed=3)
    b = partition(base_graph, cfg, driver=driver, ordering="random", order_seed=3)
    assert np.array_equal(a.labels, b.labels)


# ----------------------------------------------------- config validation


def test_config_validation_errors():
    with pytest.raises(ValueError, match="k must be >= 2"):
        BuffCutConfig(k=1)
    with pytest.raises(ValueError, match="eps"):
        BuffCutConfig(k=4, eps=0.0)
    with pytest.raises(ValueError, match="batch_size <= buffer_size"):
        BuffCutConfig(k=4, buffer_size=8, batch_size=16)
    with pytest.raises(ValueError, match="unknown score"):
        BuffCutConfig(k=4, score="bogus")
    with pytest.raises(ValueError, match="engine"):
        MultilevelConfig(engine="jax")
    with pytest.raises(ValueError, match="wave"):
        VectorizedConfig(wave=0)
    with pytest.raises(ValueError, match="queue_depth"):
        PipelineConfig(queue_depth=0)
    with pytest.raises(ValueError, match="ordering"):
        DriverConfig(ordering="zigzag")
    with pytest.raises(ValueError, match="subpart_ratio"):
        CuttanaConfig(k=4, subpart_ratio=0)
    with pytest.raises(ValueError, match="refine_passes"):
        CuttanaConfig(k=4, refine_passes=-1)
    with pytest.raises(ValueError, match="checkpoint_path"):
        DriverConfig(checkpoint_every=2)
    with pytest.raises(ValueError, match="workers"):
        DriverConfig(workers=0)
    with pytest.raises(ValueError, match="not supported with workers"):
        DriverConfig(workers=2, checkpoint_path="x.ckpt")
    with pytest.raises(TypeError, match="unknown partition option"):
        DriverConfig.create(k=4, not_a_knob=1)


def test_q1_degeneracy_allowed():
    BuffCutConfig(k=4, buffer_size=1, batch_size=64)


def test_flat_keys_route_like_the_reference():
    kw = dict(driver="cuttana", k=6, eps=0.05, subpart_ratio=8, refine_passes=1, wave=4,
              chunk=2, vec_engine="scan", queue_depth=2, prefetch_batches=1,
              ordering="bfs", order_seed=4, coarsen_target=80, lp_iters=3, seed=2,
              restream_passes=1, restream_order="priority", workers=3, load_sync_every=5,
              shard_backend="process")
    got = DriverConfig.create(engine="torch", device="cpu", **kw).to_dict()
    want = RA.DriverConfig.create(engine="sparse", **kw).to_dict()
    assert got["buffcut"]["ml"].pop("device") == "cpu"
    assert got["buffcut"]["ml"].pop("engine") == "torch"
    want["buffcut"]["ml"].pop("engine")
    # the reference's record-queue bound `read_ahead` is read by nothing:
    # the port has no such knob
    assert want["pipeline"].pop("read_ahead") == 64
    assert got == want
    with pytest.raises(TypeError, match="unknown partition option"):
        DriverConfig.create(read_ahead=7)


def test_pipeline_config_reads_the_references_dict():
    custom = {"queue_depth": 2, "read_ahead": 9, "prefetch_batches": 0}
    ref = RC.PipelineConfig(**custom).to_dict()
    assert PipelineConfig.from_dict(ref) == PipelineConfig(queue_depth=2, prefetch_batches=0)


def test_device_routes_to_the_multilevel_config():
    dc = DriverConfig.create(k=4, device="cpu")
    assert dc.buffcut.ml.device == "cpu"
    assert DriverConfig().buffcut.ml.device == "cuda"  # the default is the card


def test_buffcut_config_json_roundtrip_golden():
    cfg = BuffCutConfig(
        k=8, eps=0.05, buffer_size=64, batch_size=32, d_max=100.0,
        score="cbs", disc_factor=500, gamma=1.25,
        ml=MultilevelConfig(engine="torch", seed=3, device="cpu"), collect_stats=True,
    )
    assert BuffCutConfig.from_json(cfg.to_json()) == cfg
    assert cfg.to_dict() == {
        "k": 8, "eps": 0.05, "buffer_size": 64, "batch_size": 32,
        "d_max": 100.0, "score": "cbs", "disc_factor": 500, "gamma": 1.25,
        "ml": {
            "coarsen_target": 160, "max_levels": 10, "lp_iters": 2,
            "refine_rounds": 3, "min_shrink": 0.95, "seed": 3,
            "engine": "torch", "agg_autotune": False, "device": "cpu",
        },
        "collect_stats": True,
    }


@pytest.mark.parametrize("engine", ["auto", "sparse", "ell", "torch"])
def test_multilevel_config_json_roundtrip(engine):
    ml = MultilevelConfig(coarsen_target=80, engine=engine, seed=9, device="cpu")
    assert MultilevelConfig.from_dict(ml.to_dict()) == ml
    assert MultilevelConfig.from_dict(json.loads(json.dumps(ml.to_dict()))) == ml


def test_driver_config_json_roundtrip():
    dc = DriverConfig.create(
        driver="cuttana", k=6, subpart_ratio=8, wave=4, queue_depth=2,
        ordering="bfs", engine="sparse", device="cpu", prefetch_batches=1,
    )
    dc2 = DriverConfig.from_json(dc.to_json())
    assert dc2 == dc
    assert isinstance(dc2.buffcut, CuttanaConfig)
    assert dc2.buffcut.subpart_ratio == 8
    assert dc2.vectorized.wave == 4 and dc2.pipeline.queue_depth == 2
    assert dc2.pipeline.prefetch_batches == 1 and dc2.buffcut.ml.device == "cpu"


@pytest.mark.parametrize("engine", ["auto", "sparse", "ell"])
def test_driver_config_reads_the_references_json(engine):
    """A reference DriverConfig whose engine is not `jax` reads into the
    port, with `ml.device` at its default (the card)."""
    ref = RA.DriverConfig.create(driver="cuttana", k=6, subpart_ratio=8, wave=4,
                                 queue_depth=2, ordering="bfs", engine=engine,
                                 restream_passes=1)
    got = DriverConfig.from_json(ref.to_json())
    assert got.buffcut.ml.device == "cuda" and got.buffcut.ml.engine == engine
    d = got.to_dict()
    d["buffcut"]["ml"].pop("device")
    want = ref.to_dict()
    want["pipeline"].pop("read_ahead")  # dropped: the port has no such knob
    assert d == want


def test_config_presets_equal_the_references():
    from repro.configs import buffcut_paper as ref_paper
    from repro_torch.configs import buffcut_paper

    for name, args in (("paper_config", (32,)), ("testset_config", (16,)),
                       ("scaled_config", (4096, 8)), ("scaled_config", (100, 4))):
        got = getattr(buffcut_paper, name)(*args).to_dict()
        want = getattr(ref_paper, name)(*args).to_dict()
        assert got["ml"].pop("device") == "cuda"
        assert got == want


def test_result_json_roundtrip(base_graph, tmp_path):
    res = partition(base_graph, _cfg(), driver="buffcut")
    path = str(tmp_path / "res.json")
    text = res.to_json(path)
    for r2 in (PartitionResult.from_json(text), PartitionResult.from_json(path)):
        assert np.array_equal(r2.labels, res.labels)
        assert r2.k == res.k
        assert r2.cut_ratio == pytest.approx(res.cut_ratio)
        assert r2.balance == pytest.approx(res.balance)
        assert r2.ier == pytest.approx(res.ier)
        assert r2.provenance == res.provenance
        assert r2.stats.n_batches == res.stats.n_batches
        assert r2.stats.cut_weight == res.stats.cut_weight
    assert PartitionResult.from_json(text).to_json() == text
    with pytest.raises(ValueError, match="schema version"):
        PartitionResult.from_dict({**json.loads(text), "version": 99})


@pytest.mark.parametrize("name", ALL_NAMES)
def test_result_json_equals_the_references_apart_from_provenance(name, base_graph, ref_graph):
    got = json.loads(partition(base_graph, _cfg(), driver=name).to_json())
    want = json.loads(RA.partition(ref_graph, _ref_cfg(), driver=name).to_json())
    got_prov, want_prov = got.pop("provenance"), want.pop("provenance")
    for blob in (got, want):
        if blob["stats"] is not None:
            for key in _STATS_DROP:
                blob["stats"].pop(key, None)
    assert got == want
    for key in ("driver", "ordering", "order_seed", "restream_passes", "source", "n_total",
                "m_total"):
        assert got_prov[key] == want_prov[key], key
    assert got_prov["device"] == "cpu" and got_prov["engine"] == "sparse"


def test_result_metrics_without_graph(files):
    res = partition(files["binary"], _cfg(), driver="buffcut")
    assert res.graph is None
    assert res.cut_weight == res.stats.cut_weight
    assert res.balance == res.stats.balance
    assert 0.0 < res.cut_ratio < 1.0


# ------------------------------------------------------------------ resume


def _capture_snapshots(monkeypatch, snaps_dir: str):
    """Copy every checkpoint write into `snaps_dir`; returns the copies and a
    `stop()` that ends the copying."""
    real = ckmod.save_checkpoint
    copies = []
    active = {"on": True}

    def tee(path, state):
        real(path, state)
        if active["on"]:
            dst = os.path.join(snaps_dir, f"{len(copies):03d}.ckpt")
            shutil.copy(path, dst)
            copies.append((dst, state["kind"]))

    monkeypatch.setattr(ckmod, "save_checkpoint", tee)
    return copies, lambda: active.update(on=False)


_RESUME_KW = dict(k=8, buffer_size=64, batch_size=16, eps=0.1, device="cpu", engine="torch")


@pytest.fixture(scope="module")
def resume_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch-api-resume")
    path = str(d / "g.bcsr")
    RG.write_packed(RG.rmat_graph(300, 6, seed=3), path)
    return path


@pytest.mark.parametrize("driver,restream_passes", [
    ("buffcut", 0), ("buffcut-vec", 0), ("buffcut-pipe", 0), ("buffcut", 1),
])
def test_resume_through_the_api(driver, restream_passes, resume_file, tmp_path, monkeypatch):
    """`resume` from the first, a middle and the last snapshot of a
    checkpointed run gives the uninterrupted run's labels; with a restream
    pass the last snapshots are of the restream phase."""
    kw = dict(driver=driver, restream_passes=restream_passes, **_RESUME_KW)
    base = partition(resume_file, **kw)
    snaps = str(tmp_path / "snaps")
    os.makedirs(snaps)
    copies, stop = _capture_snapshots(monkeypatch, snaps)
    chk = partition(resume_file, checkpoint_path=str(tmp_path / "run.ckpt"),
                    checkpoint_every=2, **kw)
    stop()
    np.testing.assert_array_equal(chk.labels, base.labels)
    assert chk.stats.checkpoints_written == len(copies) >= 3
    kinds = {kind for _, kind in copies}
    assert ("restream" in kinds) == (restream_passes > 0)
    for snap, kind in (copies[0], copies[len(copies) // 2], copies[-1]):
        res = resume(snap)
        np.testing.assert_array_equal(res.labels, base.labels, err_msg=f"{snap} ({kind})")
        assert res.stats.cut_weight == base.stats.cut_weight
        assert res.provenance["device"] == "cpu"


def test_resume_rejects_wrong_config_and_corruption(resume_file, tmp_path, monkeypatch):
    copies, stop = _capture_snapshots(monkeypatch, str(tmp_path))
    partition(resume_file, driver="buffcut", checkpoint_path=str(tmp_path / "run.ckpt"),
              checkpoint_every=2, **_RESUME_KW)
    stop()
    snap, _ = copies[0]
    with pytest.raises(CheckpointError, match="config does not match"):
        resume(snap, k=9)
    with pytest.raises(CheckpointError, match="written by a"):
        resume(snap, driver="buffcut-vec")
    raw = bytearray(open(snap, "rb").read())
    raw[len(raw) // 2] ^= 0x55
    open(snap, "wb").write(bytes(raw))
    with pytest.raises(CheckpointError, match="CRC"):
        resume(snap)


def test_checkpoint_refused_for_baselines(base_graph, tmp_path):
    with pytest.raises(ValueError, match="does not support checkpointing"):
        partition(base_graph, _cfg(), driver="fennel",
                  checkpoint_path=str(tmp_path / "c.ckpt"))


# ------------------------------------------------------------------ CLI


def test_cli_partition_json_equals_the_references(files, tmp_path, capsys):
    out, ref_out = str(tmp_path / "o.json"), str(tmp_path / "r.json")
    rc = cli_main(["partition", files["binary"], "-k", "4", "--driver", "pipelined",
                   "--stats", "--device", "cpu", "--json", out])
    assert rc == 0
    assert "cut_ratio=" in capsys.readouterr().out
    assert ref_cli_main(["partition", files["binary"], "-k", "4", "--driver", "pipelined",
                         "--stats", "--engine", "sparse", "--json", ref_out]) == 0
    with open(out) as f:
        r = json.load(f)
    with open(ref_out) as f:
        want = json.load(f)
    assert r["k"] == 4 and r["labels"] == want["labels"]
    assert r["metrics"] == want["metrics"]
    assert r["provenance"]["driver"] == "buffcut-pipe"
    assert r["provenance"]["device"] == "cpu" and r["provenance"]["engine"] == "auto"


@pytest.mark.parametrize("engine", ["sparse", "ell", "torch"])
def test_cli_engines_on_the_cpu(engine, tmp_path):
    out = str(tmp_path / "o.json")
    assert cli_main(["partition", "gen:grid:side=24", "-k", "4", "--engine", engine,
                     "--device", "cpu", "--json", out]) == 0
    want = RA.partition("gen:grid:side=24", RA.DriverConfig.create(
        RA.DriverConfig(buffcut=__import__("repro.configs.buffcut_paper",
                                           fromlist=["x"]).scaled_config(576, k=4)),
        engine="sparse"))
    assert json.load(open(out))["labels"] == want.labels.tolist()


@pytest.mark.parametrize("family,params,fmt", [
    ("grid", ["side=8"], "packed"), ("ring", ["n=40"], "packed"),
    ("rmat", ["n=128", "avg_degree=5", "seed=7"], "packed"), ("grid", ["side=8"], "metis"),
    ("sbm", ["n=96", "n_blocks=4", "p_in=0.2", "p_out=0.01", "seed=2"], "metis"),
])
def test_cli_gen_files_equal_the_references(family, params, fmt, tmp_path, capsys):
    p, q = str(tmp_path / "a"), str(tmp_path / "b")
    args = [arg for kv in params for arg in ("--param", kv)]
    assert cli_main(["gen", family, "-o", p, "--format", fmt, *args]) == 0
    assert ref_cli_main(["gen", family, "-o", q, "--format", fmt, *args]) == 0
    assert open(p, "rb").read() == open(q, "rb").read()
    assert f"wrote {p}" in capsys.readouterr().out


def test_cli_gen_then_partition_and_list(tmp_path, capsys):
    p = str(tmp_path / "m.bcsr")
    assert cli_main(["gen", "grid", "-o", p, "--param", "side=8"]) == 0
    assert cli_main(["partition", p, "-k", "4", "--device", "cpu"]) == 0
    assert cli_main(["list", "-v"]) == 0
    out = capsys.readouterr().out
    for name in ALL_NAMES:
        assert name in out
    assert "caps: disk-stream, checkpoint, shard, dynamic  aliases: sequential" in out


def test_cli_error_paths(files, tmp_path, capsys):
    assert cli_main(["partition", str(tmp_path / "missing.bcsr"), "-k", "4",
                     "--device", "cpu"]) == 1
    assert cli_main(["partition", files["binary"], "-k", "4", "--driver", "nope",
                     "--device", "cpu"]) == 1
    assert cli_main(["partition", files["binary"], "-k", "4", "--driver", "heistream",
                     "--device", "cpu"]) == 1
    assert cli_main(["partition", files["binary"], "--device", "cpu"]) == 1  # no -k
    err = capsys.readouterr().err
    assert "memory-only" in err and "-k is required" in err
    with pytest.raises(SystemExit):
        cli_main(["partition", files["binary"], "-k", "4", "--engine", "jax"])
    with pytest.raises(SystemExit):
        cli_main(["partition", files["binary"], "-k", "4", "--device", "tpu"])


def test_cli_materialize_unlocks_memory_only(files, ref_graph, tmp_path):
    out = str(tmp_path / "h.json")
    assert cli_main(["partition", files["binary"], "-k", "4", "--driver", "heistream",
                     "--materialize", "--device", "cpu", "--json", out]) == 0
    assert json.load(open(out))["provenance"]["driver"] == "heistream"


def test_cli_resume(files, tmp_path):
    ck, a, b = (str(tmp_path / x) for x in ("c.ckpt", "a.json", "b.json"))
    assert cli_main(["partition", files["binary"], "-k", "4", "--device", "cpu",
                     "--buffer-size", "24", "--batch-size", "8", "--checkpoint", ck,
                     "--checkpoint-every", "1", "--json", a]) == 0
    assert cli_main(["partition", "--resume", ck, "--json", b]) == 0
    assert json.load(open(a))["labels"] == json.load(open(b))["labels"]


# ------------------------------------------------------------- the card


def test_partition_on_missing_card_raises(base_graph, files, capsys, monkeypatch):
    """The default device is the card: with none, the API raises before
    any work and the CLI fails before it reads the source; neither runs on
    the host."""
    import repro_torch.api as api_mod

    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card error path cannot be shown")
    resolved = []
    real_resolve = api_mod.resolve_source
    monkeypatch.setattr(api_mod, "resolve_source",
                        lambda s: resolved.append(s) or real_resolve(s))
    assert cli_main(["partition", "gen:grid:side=8", "-k", "2"]) == 1
    assert resolved == [] and "no CUDA device" in capsys.readouterr().err
    monkeypatch.setattr(api_mod, "resolve_source", real_resolve)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        partition(base_graph, k=4)
    cfg = dataclasses.replace(_cfg("torch"), ml=MultilevelConfig(engine="torch"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        partition(base_graph, cfg, driver="heistream")
    assert cli_main(["partition", files["binary"], "-k", "4"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    # the host engine needs no card
    assert partition(base_graph, k=4, engine="sparse").labels.shape == (base_graph.n,)
