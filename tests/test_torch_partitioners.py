"""repro_torch's partitioners against repro's: the invariants of
tests/test_core_partitioners.py on the port's legacy entry points (every
node assigned once, the balance cap, a cut below random, the paper-claim
directions), and each baseline (HeiStream on the host `sparse` engine and
on the device `torch` engine on the CPU, Cuttana, Fennel, LDG) giving
labels bit-equal to the reference's.  The legacy functions warn
(`DeprecationWarning`) and delegate; the warning is part of the contract."""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.core as R
import repro.graphs as RG
from repro_torch.convert import graph_from_numpy
from repro_torch.core import (
    BuffCutConfig,
    CuttanaConfig,
    MultilevelConfig,
    VectorizedConfig,
    balance,
    buffcut_partition,
    buffcut_partition_pipelined,
    buffcut_partition_vectorized,
    cut_ratio,
    cuttana_partition,
    edge_cut,
    fennel_partition,
    heistream_partition,
    ldg_partition,
    restream,
)
from repro_torch.core.metrics import l_max
from repro_torch.graphs import aid_per_node, geometric_mean, mean_aid

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


def _port(g):
    return graph_from_numpy(g.indptr, g.indices, g.edge_w, g.node_w)


def _kw(g, k=8, **kw):
    base = dict(k=k, buffer_size=max(g.n // 8, 16), batch_size=max(g.n // 16, 8),
                d_max=max(g.n / 8, 32))
    base.update(kw)
    return base


def _cfg(g, engine="sparse", **kw):
    return BuffCutConfig(**_kw(g, **kw), ml=MultilevelConfig(engine=engine, device="cpu"))


def _is_balanced(g, block, k, eps):
    loads = np.bincount(block, weights=g.node_w.astype(np.float64), minlength=k)
    return loads.max() <= l_max(float(g.node_w.astype(np.float64).sum()), k, eps) + 1e-9


PARTITIONERS = {
    "buffcut": lambda g, cfg: buffcut_partition(g, cfg)[0],
    "heistream": lambda g, cfg: heistream_partition(g, cfg)[0],
    "cuttana": lambda g, cfg: cuttana_partition(
        g, CuttanaConfig(k=cfg.k, buffer_size=cfg.buffer_size, batch_size=cfg.batch_size,
                         d_max=cfg.d_max, ml=cfg.ml))[0],
    "fennel": lambda g, cfg: fennel_partition(g, cfg.k, cfg.eps),
    "ldg": lambda g, cfg: ldg_partition(g, cfg.k, cfg.eps),
    "vectorized": lambda g, cfg: buffcut_partition_vectorized(
        g, cfg, VectorizedConfig(wave=8, chunk=8))[0],
    "pipelined": lambda g, cfg: buffcut_partition_pipelined(g, cfg)[0],
}

REF_PARTITIONERS = {
    "buffcut": lambda g, kw: R.buffcut_partition(g, R.BuffCutConfig(**kw))[0],
    "heistream": lambda g, kw: R.heistream_partition(g, R.BuffCutConfig(**kw))[0],
    "cuttana": lambda g, kw: R.cuttana_partition(g, R.CuttanaConfig(**kw))[0],
    "fennel": lambda g, kw: R.fennel_partition(g, kw["k"]),
    "ldg": lambda g, kw: R.ldg_partition(g, kw["k"]),
    "vectorized": lambda g, kw: R.buffcut_partition_vectorized(
        g, R.BuffCutConfig(**kw), wave=8, chunk=8)[0],
    "pipelined": lambda g, kw: R.buffcut_partition_pipelined(g, R.BuffCutConfig(**kw))[0],
}


@pytest.mark.parametrize("name", sorted(PARTITIONERS))
def test_partitioner_invariants(name, random_grid):
    """Every node assigned exactly once; balance cap respected; k blocks; a
    cut below random assignment's; labels equal to the reference's."""
    g = _port(random_grid)
    cfg = _cfg(g)
    block = PARTITIONERS[name](g, cfg)
    assert block.shape == (g.n,)
    assert (block >= 0).all() and (block < cfg.k).all()
    assert _is_balanced(g, block, cfg.k, cfg.eps), balance(g, block, cfg.k)
    rng = np.random.default_rng(0)
    assert cut_ratio(g, block) < cut_ratio(g, rng.integers(0, cfg.k, g.n))
    want = REF_PARTITIONERS[name](random_grid, _kw(g))
    np.testing.assert_array_equal(block, want)


@pytest.mark.parametrize("name", ["buffcut", "heistream", "cuttana", "fennel", "ldg"])
def test_legacy_functions_warn(name, small_grid):
    g = _port(small_grid)
    with pytest.warns(DeprecationWarning, match="repro_torch.api.partition"):
        PARTITIONERS[name](g, _cfg(g))


@pytest.mark.parametrize("engine", ["sparse", "torch"])
@pytest.mark.parametrize("fixture", ["random_grid", "small_rmat", "small_sbm"])
def test_heistream_matches_reference(fixture, engine, request):
    """HeiStream's contiguous batches through the port's V-cycle (host
    `sparse`, or `torch` on the CPU): labels and stats equal the
    reference's `sparse` run."""
    ref_g = request.getfixturevalue(fixture)
    g = _port(ref_g)
    kw = _kw(g, collect_stats=True)
    want, want_s = R.heistream_partition(ref_g, R.BuffCutConfig(**kw))
    got, got_s = heistream_partition(g, _cfg(g, engine, collect_stats=True))
    np.testing.assert_array_equal(got, want)
    assert (got_s.n_batches, got_s.ier_per_batch, got_s.peak_mem_items) == (
        want_s.n_batches, want_s.ier_per_batch, want_s.peak_mem_items)


@pytest.mark.parametrize("ratio,passes", [(16, 2), (4, 0), (64, 3)])
@pytest.mark.parametrize("fixture", ["random_grid", "small_rmat", "small_sbm"])
def test_cuttana_matches_reference(fixture, ratio, passes, request):
    ref_g = request.getfixturevalue(fixture)
    g = _port(ref_g)
    kw = _kw(g, subpart_ratio=ratio, refine_passes=passes, collect_stats=True)
    want, want_s = R.cuttana_partition(ref_g, R.CuttanaConfig(**kw))
    got, got_s = cuttana_partition(g, CuttanaConfig(**kw))
    np.testing.assert_array_equal(got, want)
    assert (got_s.n_hubs, got_s.peak_mem_items) == (want_s.n_hubs, want_s.peak_mem_items)


def test_cuttana_hubs_match_reference():
    ref_g = RG.star_graph(300)
    g = _port(ref_g)
    kw = dict(k=4, buffer_size=32, batch_size=16, d_max=50)
    want, want_s = R.cuttana_partition(ref_g, R.CuttanaConfig(**kw))
    got, got_s = cuttana_partition(g, CuttanaConfig(**kw))
    np.testing.assert_array_equal(got, want)
    assert got_s.n_hubs == want_s.n_hubs == 1


@pytest.mark.parametrize("k,eps,gamma", [(2, 0.03, 1.5), (8, 0.03, 1.5), (5, 0.1, 2.0),
                                         (16, 0.01, 1.25)])
@pytest.mark.parametrize("fixture", ["random_grid", "small_rmat", "small_sbm"])
def test_fennel_and_ldg_match_reference(fixture, k, eps, gamma, request):
    ref_g = request.getfixturevalue(fixture)
    g = _port(ref_g)
    np.testing.assert_array_equal(fennel_partition(g, k, eps, gamma),
                                  R.fennel_partition(ref_g, k, eps, gamma))
    np.testing.assert_array_equal(ldg_partition(g, k, eps), R.ldg_partition(ref_g, k, eps))


@pytest.mark.parametrize("name", ["heistream", "cuttana", "fennel", "ldg"])
def test_memory_only_baselines_refuse_streams(name, small_grid):
    from repro_torch.graphs import NodeStream

    g = _port(small_grid)
    with pytest.raises(TypeError, match="memory-only"):
        PARTITIONERS[name](NodeStream(g), _cfg(g))


def test_buffcut_deterministic(random_grid):
    g = _port(random_grid)
    cfg = _cfg(g)
    b1, _ = buffcut_partition(g, cfg)
    b2, _ = buffcut_partition(g, cfg)
    assert np.array_equal(b1, b2)


@pytest.mark.parametrize("engine", ["sparse", "torch"])
def test_q1_equals_heistream(engine, random_grid):
    """Paper sanity: Q_max=1 degenerates to contiguous batches (HeiStream)."""
    g = _port(random_grid)
    cfg = _cfg(g, engine, buffer_size=1)
    bb, _ = buffcut_partition(g, cfg)
    hh, _ = heistream_partition(g, cfg)
    assert edge_cut(g, bb) == pytest.approx(edge_cut(g, hh))


def test_buffer_improves_cut_under_random_order(random_grid):
    """Paper Fig. 5 direction: larger buffer => lower cut, higher IER."""
    g = _port(random_grid)
    cuts, iers = [], []
    for q in (1, g.n // 8, g.n // 3):
        b, st_ = buffcut_partition(g, _cfg(g, buffer_size=max(q, 1), collect_stats=True))
        cuts.append(edge_cut(g, b))
        iers.append(st_.mean_ier)
    assert cuts[-1] < cuts[0]
    assert iers[-1] > iers[0]


def test_buffcut_beats_heistream_on_random_order(random_grid):
    g = _port(random_grid)
    cfg = _cfg(g)
    bb, _ = buffcut_partition(g, cfg)
    hh, _ = heistream_partition(g, cfg)
    assert edge_cut(g, bb) < edge_cut(g, hh)


def test_restream_improves(random_grid):
    """Paper Table 2 direction: extra passes reduce cut, keep balance, in
    both replay orders."""
    g = _port(random_grid)
    cfg = _cfg(g)
    b0, _ = buffcut_partition(g, cfg)
    for order in ("stream", "priority"):
        b1 = restream(g, b0, cfg, 1, order=order)
        assert edge_cut(g, b1) <= edge_cut(g, b0), order
        assert _is_balanced(g, b1, cfg.k, cfg.eps), order


def test_hub_bypass():
    """Nodes above D_max are Fennel-assigned immediately (counted)."""
    g = _port(RG.star_graph(300))
    cfg = BuffCutConfig(k=4, buffer_size=32, batch_size=16, d_max=50, collect_stats=True,
                        ml=MultilevelConfig(engine="sparse", device="cpu"))
    block, st_ = buffcut_partition(g, cfg)
    assert st_.n_hubs == 1
    assert _is_balanced(g, block, 4, cfg.eps)


def test_vectorized_wave1_quality_parity(random_grid):
    g = _port(random_grid)
    cfg = _cfg(g)
    bs, _ = buffcut_partition(g, cfg)
    bv, _ = buffcut_partition_vectorized(g, cfg, VectorizedConfig(wave=1, chunk=1))
    assert abs(cut_ratio(g, bv) - cut_ratio(g, bs)) < 0.05


def test_sbm_recovers_communities(small_sbm):
    g = _port(small_sbm)
    block, _ = buffcut_partition(g, _cfg(g, k=8))
    rng = np.random.default_rng(0)
    assert cut_ratio(g, block) < 0.6 * cut_ratio(g, rng.integers(0, 8, g.n))


def test_all_scores_run(random_grid):
    g = _port(random_grid)
    for score in ("anr", "cbs", "haa", "nss", "cms"):
        cfg = _cfg(g, score=score)
        block, _ = buffcut_partition(g, cfg)
        assert _is_balanced(g, block, cfg.k, cfg.eps), score


@given(st.integers(2, 16), st.floats(0.01, 0.2))
@settings(max_examples=10, deadline=None)
def test_balance_property(k, eps):
    """Property: any k, eps -> balanced output on a fixed graph, equal to
    the reference's."""
    ref_g = RG.grid_mesh_graph(16)
    g = _port(ref_g)
    kw = dict(k=k, eps=eps, buffer_size=32, batch_size=16, d_max=64)
    cfg = BuffCutConfig(**kw, ml=MultilevelConfig(engine="sparse", device="cpu"))
    block, _ = buffcut_partition(g, cfg)
    assert _is_balanced(g, block, k, eps)
    assert (np.bincount(block, minlength=k) > 0).sum() >= min(k, g.n)
    np.testing.assert_array_equal(block, R.buffcut_partition(ref_g, R.BuffCutConfig(**kw))[0])


def test_locality_metrics_match_reference(random_grid, small_rmat):
    from repro.graphs import locality as ref_locality

    for ref_g in (random_grid, small_rmat):
        got = aid_per_node(_port(ref_g))
        assert got.tobytes() == ref_locality.aid_per_node(ref_g).tobytes()
        assert mean_aid(_port(ref_g)) == ref_locality.mean_aid(ref_g)
    vals = np.array([0.0, 1e-3, 2.5, 40.0])
    assert geometric_mean(vals) == ref_locality.geometric_mean(vals)


def test_sorted_neighbor_label_weights_match_reference(small_rmat):
    from repro_torch.core import neighbor_label_weights, sorted_neighbor_label_weights

    g = _port(small_rmat)
    labels = np.random.default_rng(5).integers(0, 7, g.n) << 36  # labels far past n
    got = sorted_neighbor_label_weights(g, labels)
    for a, b in zip(got, R.sorted_neighbor_label_weights(small_rmat, labels)):
        assert a.tobytes() == b.tobytes()
    for a, b in zip(got, neighbor_label_weights(g, labels)):
        np.testing.assert_array_equal(a, b)
