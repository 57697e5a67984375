"""repro_torch's V-cycle engines against repro's: labels from the port's
`sparse`, `ell` and `torch` (on the CPU, in every aggregation mode)
engines equal the reference `sparse` engine's; a private copy of the
reference JAX engine agrees too, and so does the initial Fennel sweep on
the CPU against the reference's `_initial_fennel`; the sequential Fennel
loop is bit-identical.  On fractional edge weights (uniform(0.5, 2.0)),
where the engines sum in different orders, the labels of all of them
still agree, the V-cycle's and the initial sweep's alike."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core
import repro.graphs as rg
from repro.core.batch_model import build_batch_model as ref_build_batch_model
from repro.core.fennel import FennelParams as RefFennelParams
from repro.core.multilevel import MultilevelConfig as RefConfig
from repro.core.multilevel import multilevel_partition as ref_multilevel
from repro.kernels.fennel_gain import fennel_gain_sequential as ref_fennel_sequential
import repro_torch.core.multilevel_torch as mlt
from repro_torch.convert import graph_from_numpy
from repro_torch.core import multilevel as tml
from repro_torch.core.fennel import FennelParams
from repro_torch.graphs.csr import bucket_size
from repro_torch.kernels import _build
from repro_torch.kernels import fennel_gain as fg
from repro_torch.kernels.fennel_gain import fennel_gain_sequential


def _port(g):
    return graph_from_numpy(g.indptr, g.indices, g.edge_w, g.node_w)


def _batch_model_case():
    rng = np.random.default_rng(0)
    g = rg.rmat_graph(512, 8, seed=3)
    k = 8
    block = np.full(g.n, -1, dtype=np.int64)
    block[:200] = rng.integers(0, k, 200)
    loads = np.bincount(block[:200], weights=g.node_w[:200], minlength=k).astype(np.float64)
    model = ref_build_batch_model(g, np.arange(200, 420), block, k)
    return model.graph, model.pinned_block, k, loads, 0.05


def _ordered_case(base, order, k):
    def make():
        g = rg.apply_order(base(), order(base()))
        return g, np.full(g.n, -1, dtype=np.int64), k, np.zeros(k), 0.1
    return make


def _k_exceeds_node_bucket():
    g = rg.rmat_graph(40, 4, seed=0)
    return g, np.full(g.n, -1, dtype=np.int64), 100, np.zeros(100), 0.1


CASES = {
    "batch_model": _batch_model_case,
    "rmat_natural": _ordered_case(lambda: rg.rmat_graph(384, 8, seed=11), rg.source_order, 6),
    "rmat_bfs": _ordered_case(lambda: rg.rmat_graph(384, 8, seed=11), rg.bfs_order, 6),
    "rmat_adversarial": _ordered_case(lambda: rg.rmat_graph(384, 8, seed=11), rg.konect_order, 6),
    "grid_natural": _ordered_case(lambda: rg.grid_mesh_graph(24), rg.source_order, 4),
    "grid_bfs": _ordered_case(lambda: rg.grid_mesh_graph(24), rg.bfs_order, 4),
    "grid_adversarial": _ordered_case(lambda: rg.grid_mesh_graph(24), rg.konect_order, 4),
    "k_exceeds_node_bucket": _k_exceeds_node_bucket,
}

# (port engine, forced aggregation mode of the torch engine)
ENGINES = [("sparse", None), ("ell", None), ("torch", None), ("torch", "dense"),
           ("torch", "sort"), ("torch", "ell")]


def _params(g, k, eps):
    ref = RefFennelParams(k=k, n_total=float(g.node_w.sum()),
                          m_total=g.total_edge_weight(), eps=eps)
    return ref, FennelParams(k=k, n_total=ref.n_total, m_total=ref.m_total, eps=eps)


@pytest.mark.parametrize("engine,mode", ENGINES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_port_engines_match_reference_sparse(case, engine, mode, monkeypatch):
    g, pinned, k, loads, eps = CASES[case]()
    ref_p, p = _params(g, k, eps)
    want = ref_multilevel(g, pinned, ref_p, loads, RefConfig(engine="sparse"))
    monkeypatch.setattr(mlt, "MODE_OVERRIDE", mode)
    got = tml.multilevel_partition(_port(g), pinned, p, loads,
                                   tml.MultilevelConfig(engine=engine, device="cpu"))
    np.testing.assert_array_equal(got, want)


def _private_jax_engine():
    """Load repro/core/multilevel_jax.py as a private module (never put in
    sys.modules): its `from jax.experimental import enable_x64` is bound to
    `jax.enable_x64` only while the module executes."""
    import jax
    import jax.experimental

    path = Path(repro.core.__file__).parent / "multilevel_jax.py"
    spec = importlib.util.spec_from_file_location("_private_multilevel_jax", path)
    mod = importlib.util.module_from_spec(spec)
    had = hasattr(jax.experimental, "enable_x64")
    if not had:
        jax.experimental.enable_x64 = jax.enable_x64
    try:
        spec.loader.exec_module(mod)
    finally:
        if not had:
            del jax.experimental.enable_x64
    return mod


@pytest.fixture(scope="module")
def jax_engine():
    return _private_jax_engine()


@pytest.mark.parametrize("mode", ["dense", "sort", "ell"])
def test_torch_engine_matches_reference_jax_engine(mode, jax_engine, monkeypatch):
    import sys

    g = rg.grid_mesh_graph(64)
    k = 4
    pinned = np.full(g.n, -1, dtype=np.int64)
    ref_p, p = _params(g, k, 0.1)
    monkeypatch.setattr(jax_engine, "MODE_OVERRIDE", mode)
    monkeypatch.setattr(mlt, "MODE_OVERRIDE", mode)
    want = jax_engine.multilevel_partition_jax(g, pinned, ref_p, np.zeros(k),
                                               RefConfig(engine="jax"))
    got = tml.multilevel_partition(_port(g), pinned, p, np.zeros(k),
                                   tml.MultilevelConfig(engine="torch", device="cpu"))
    np.testing.assert_array_equal(got, want)
    assert "repro.core.multilevel_jax" not in sys.modules


def _sweep_case(k, seed, fractional=False):
    """A coarsest level for `_initial_fennel`: src-sorted padded edge arrays
    with zero-weight edges and a hub of 90 neighbours, pinned nodes, a free
    node with no neighbours, pads past n, and a cap under the average load,
    so that the last steps find no feasible block.  `fractional` redraws
    the nonzero edge weights from uniform(0.5, 2.0) (a second generator, so
    the level is otherwise the same)."""
    rng = np.random.default_rng(seed)
    n, n_pad, hub, lone = 150, 256, 7, 11
    src = np.concatenate([rng.integers(0, n, 600), np.full(90, hub)])
    dst = rng.integers(0, n, src.size)
    keep = (src != dst) & (src != lone) & (dst != lone)
    src, dst = src[keep], dst[keep]
    by_src = np.argsort(src, kind="stable")
    e = src.size
    e_pad = bucket_size(e)
    esrc, edst = np.full(e_pad, n_pad), np.full(e_pad, n_pad)
    esrc[:e], edst[:e] = src[by_src], dst[by_src]
    ew = np.zeros(e_pad)
    ew[:e] = rng.integers(0, 4, e)  # a quarter of the edges weigh 0
    if fractional:
        frac = np.random.default_rng(seed + 1).uniform(0.5, 2.0, e)
        ew[:e] = np.where(ew[:e] > 0, frac, 0.0)
    node_w = np.zeros(n_pad)
    node_w[:n] = rng.integers(1, 4, n)
    pinned = np.full(n_pad, -2)
    pinned[:n] = -1
    pin = rng.choice(np.setdiff1d(np.arange(n), [hub, lone]), 20, replace=False)
    pinned[pin] = rng.integers(0, k, pin.size)
    loads0 = np.bincount(pinned[pin], weights=node_w[pin], minlength=k).astype(np.float64)
    free = pinned[:n] == -1
    cap = 0.97 * (loads0.sum() + node_w[:n][free].sum()) / k
    assert loads0.max() <= cap  # a load past cap at the end comes from a fallback step
    deg = np.bincount(src, minlength=n)
    w_c = min(bucket_size(int(deg[free].max()), minimum=64), e_pad)
    return (esrc, edst, ew, node_w, pinned), n, int(free.sum()), loads0, cap, w_c


@pytest.mark.parametrize("k", [2, 32, 40])
@pytest.mark.parametrize("gamma", [1.5, 2.0, 3.0])
def test_initial_fennel_matches_reference(gamma, k, jax_engine, monkeypatch):
    """The port's `_initial_fennel` on CPU tensors (the sweep's plain
    version) against the reference's jitted fori_loop: labels and loads
    equal, bit for bit, and nothing built or launched."""
    import jax.numpy as jnp

    arrays, n, n_free, loads0, cap, w_c = _sweep_case(k, seed=k)
    alpha = 0.4
    with jax_engine.enable_x64():
        want = jax_engine._initial_fennel(*map(jnp.asarray, arrays), n, jnp.asarray(loads0),
                                          alpha, gamma, cap, w_c=w_c)
        want_labels, want_loads = (np.asarray(a) for a in want)

    def no_build(*a, **kw):
        raise AssertionError("the CPU route built a kernel")

    monkeypatch.setattr(_build, "build_all", no_build)
    monkeypatch.setattr(_build, "load", no_build)
    before = fg.sweep_launches
    labels, loads = mlt._initial_fennel(*map(torch.from_numpy, arrays), n, n_free,
                                        torch.from_numpy(loads0), alpha, gamma, cap, w_c=w_c)
    assert fg.sweep_launches == before
    np.testing.assert_array_equal(labels.numpy(), want_labels)
    assert loads.numpy().tobytes() == want_loads.tobytes()  # bitwise, not approx
    assert bool((labels[:n] >= 0).all()) and bool((labels[n:] == -1).all())
    assert loads.max() > cap  # some step took the least-loaded fallback


def _fractional(g, seed):
    """`g` (a reference CSRGraph) with its edge weights redrawn from a
    seeded uniform(0.5, 2.0), symmetric per undirected edge."""
    src = np.repeat(np.arange(g.n), np.diff(g.indptr))
    dst = g.indices.astype(np.int64)
    edges = np.stack([src, dst], 1)[src < dst]
    w = np.random.default_rng(seed).uniform(0.5, 2.0, edges.shape[0])
    return rg.CSRGraph.from_edges(g.n, edges, w)


def _fractional_batch_model(graph, seed):
    """The batch model of nodes [2n/5, 4n/5) of a fractional-weight mesh or
    R-MAT graph, after the first 2n/5 nodes took random blocks."""
    base, k = {"mesh": (lambda: rg.grid_mesh_graph(40), 4),
               "rmat": (lambda: rg.rmat_graph(1024, 8, seed=3), 8)}[graph]
    g = _fractional(base(), seed)
    a, b = 2 * g.n // 5, 4 * g.n // 5
    block = np.full(g.n, -1, dtype=np.int64)
    block[:a] = np.random.default_rng(seed).integers(0, k, a)
    loads = np.bincount(block[:a], weights=g.node_w[:a], minlength=k).astype(np.float64)
    model = ref_build_batch_model(g, np.arange(a, b), block, k)
    return model.graph, model.pinned_block, k, loads


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("mode", ["dense", "sort", "ell"])
@pytest.mark.parametrize("graph", ["mesh", "rmat"])
def test_fractional_weights_torch_engine_matches_reference(graph, mode, seed, jax_engine,
                                                           monkeypatch):
    """Edge weights from uniform(0.5, 2.0): the port's `torch` engine (on
    the CPU, in every forced aggregation mode) gives the labels of the
    reference's jax engine (its private copy, in the same mode) and of the
    reference's `sparse` engine.  The three sum in different orders (torch's
    reductions, XLA's, numpy's sequential adds); the labels agree."""
    g, pinned, k, loads = _fractional_batch_model(graph, seed)
    assert not np.array_equal(g.edge_w, np.round(g.edge_w))
    ref_p, p = _params(g, k, 0.05)
    want_sparse = ref_multilevel(g, pinned, ref_p, loads, RefConfig(engine="sparse"))
    monkeypatch.setattr(jax_engine, "MODE_OVERRIDE", mode)
    monkeypatch.setattr(mlt, "MODE_OVERRIDE", mode)
    want_jax = jax_engine.multilevel_partition_jax(g, pinned, ref_p, loads,
                                                   RefConfig(engine="jax"))
    got = tml.multilevel_partition(_port(g), pinned, p, loads,
                                   tml.MultilevelConfig(engine="torch", device="cpu"))
    np.testing.assert_array_equal(got, want_jax)
    np.testing.assert_array_equal(got, want_sparse)


@pytest.mark.parametrize("engine", ["sparse", "ell"])
@pytest.mark.parametrize("graph", ["mesh", "rmat"])
def test_fractional_weights_host_engines_match_reference(graph, engine):
    g, pinned, k, loads = _fractional_batch_model(graph, 1)
    ref_p, p = _params(g, k, 0.05)
    want = ref_multilevel(g, pinned, ref_p, loads, RefConfig(engine="sparse"))
    got = tml.multilevel_partition(_port(g), pinned, p, loads,
                                   tml.MultilevelConfig(engine=engine, device="cpu"))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [2, 32, 40])
@pytest.mark.parametrize("gamma", [1.5, 3.0])
def test_fractional_weights_initial_fennel_matches_reference(gamma, k, jax_engine):
    """`_initial_fennel` alone on a level with weights from uniform(0.5,
    2.0): the port's plain sweep against the jax engine copy's fori_loop
    and against the reference `sparse` engine's sequential sweep
    (`fennel_gain_sequential`, left-to-right adds in segment order, the
    order of the sweep kernel): labels and loads bit for bit."""
    import jax.numpy as jnp

    arrays, n, n_free, loads0, cap, w_c = _sweep_case(k, seed=k, fractional=True)
    esrc, edst, ew, node_w, pinned = arrays
    assert not np.array_equal(ew, np.round(ew))
    alpha = 0.4
    with jax_engine.enable_x64():
        want = jax_engine._initial_fennel(*map(jnp.asarray, arrays), n, jnp.asarray(loads0),
                                          alpha, gamma, cap, w_c=w_c)
        want_labels, want_loads = (np.asarray(a) for a in want)
    labels, loads = mlt._initial_fennel(*map(torch.from_numpy, arrays), n, n_free,
                                        torch.from_numpy(loads0), alpha, gamma, cap, w_c=w_c)
    np.testing.assert_array_equal(labels.numpy(), want_labels)
    assert loads.numpy().tobytes() == want_loads.tobytes()
    # the reference sparse engine's sweep over the same level in CSR form
    e = int((esrc < n).sum())
    indptr = np.searchsorted(esrc[:e], np.arange(n + 1))
    free = np.nonzero(pinned[:n] == -1)[0]
    order = free[np.lexsort((free, -node_w[free]))]
    seq_labels = np.where(pinned[:n] >= 0, pinned[:n], -1).astype(np.int64)
    seq_loads = loads0.copy()
    ref_fennel_sequential(indptr, edst[:e], ew[:e], node_w[:n], order, seq_labels, seq_loads,
                          alpha=alpha, gamma=gamma, cap=cap, k=k)
    np.testing.assert_array_equal(labels.numpy()[:n], seq_labels)
    assert loads.numpy().tobytes() == seq_loads.tobytes()


@pytest.mark.parametrize("gamma", [1.5, 2.0, 3.0])
def test_fennel_gain_sequential_bit_identical(gamma):
    rng = np.random.default_rng(13)
    g = rg.rmat_graph(256, 6, seed=21)
    k = 5
    p = RefFennelParams(k=k, n_total=float(g.node_w.sum()),
                        m_total=g.total_edge_weight(), eps=0.08, gamma=gamma)
    labels0 = np.full(g.n, -1, dtype=np.int64)
    pin = rng.choice(g.n, 60, replace=False)
    labels0[pin] = rng.integers(0, k, pin.size)
    loads0 = np.bincount(labels0[pin], weights=g.node_w[pin], minlength=k).astype(np.float64)
    free = np.nonzero(labels0 < 0)[0]
    order = free[np.lexsort((free, -g.node_w[free]))]
    out = []
    for fn in (ref_fennel_sequential, fennel_gain_sequential):
        labels, loads = labels0.copy(), loads0.copy()
        fn(g.indptr, g.indices, g.edge_w, g.node_w, order, labels, loads,
           alpha=p.alpha, gamma=p.gamma, cap=p.cap, k=k)
        out.append((labels, loads))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert out[0][1].tobytes() == out[1][1].tobytes()  # bitwise, not approx


def test_auto_engine_resolves_by_device():
    g = _port(rg.grid_mesh_graph(8))
    assert tml._resolve_engine("auto", g, "cpu") == "sparse"
    assert tml._resolve_engine("auto", g, "cuda") == "ell"
    assert tml._resolve_engine("torch", g, "cuda") == "sparse"
    with pytest.raises(ValueError):
        tml.MultilevelConfig(engine="jax")


def test_pick_mode_takes_the_kernel_only_on_a_card():
    # the full-width batch: n_pad = 65536, mesh rows fit 8-wide tiles, k = 32
    assert mlt._pick_mode(65536, 32, 8, on_card=True) == "ell"
    assert mlt._pick_mode(65536, 32, 8, on_card=False) == "dense"
    assert mlt._pick_mode(65536, 65536, 8, on_card=True) == "sort"  # clustering
    assert mlt._pick_mode(65536, 32, 512, on_card=True) == "dense"  # too wide
    assert mlt._pick_mode(2048, 2048, None, on_card=True) == "dense"


def test_torch_engine_on_missing_card_raises():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present: the no-card error path cannot be shown")
    g, pinned, k, loads, eps = _batch_model_case()
    _, p = _params(g, k, eps)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tml.multilevel_partition(_port(g), pinned, p, loads,
                                 tml.MultilevelConfig(engine="torch"))


def test_device_engine_failure_propagates_through_driver(monkeypatch):
    """The port has no per-batch host fallback: an error inside the device
    engine (a kernel that does not launch, a CUDA fault) fails the run."""
    from repro_torch.core import BuffCutConfig, buffcut_partition

    def broken(*a, **kw):
        raise RuntimeError("device lost mid-stream")

    monkeypatch.setattr(mlt, "multilevel_partition_torch", broken)
    g = rg.grid_mesh_graph(12)
    cfg = BuffCutConfig(k=4, buffer_size=64, batch_size=32,
                        ml=tml.MultilevelConfig(engine="torch", device="cpu"))
    with pytest.raises(RuntimeError, match="device lost mid-stream"):
        buffcut_partition(_port(g), cfg)


def test_agg_autotune_identical_labels_and_converges():
    """agg_autotune explores both aggregation modes per (phase, shape) and
    commits to the measured-fastest; exploration never changes a label."""
    g = rg.rmat_graph(768, 8, seed=9)
    k = 6
    pinned = np.full(g.n, -1, dtype=np.int64)
    ref_p, p = _params(g, k, 0.1)
    want = ref_multilevel(g, pinned, ref_p, np.zeros(k), RefConfig(engine="sparse"))
    mlt.reset_agg_tuner()
    try:
        cfg = tml.MultilevelConfig(engine="torch", device="cpu", agg_autotune=True)
        for _ in range(2 * (mlt._AggTuner.WARMUP + mlt._AggTuner.TIMED) + 1):
            got = tml.multilevel_partition(_port(g), pinned, p, np.zeros(k), cfg)
            np.testing.assert_array_equal(got, want)
        decisions = mlt.agg_decisions()
        assert decisions and set(decisions.values()) <= {"dense", "sort"}
        assert {phase for phase, _, _ in decisions} <= {"cluster", "refine"}
    finally:
        mlt.reset_agg_tuner()
    tml.multilevel_partition(_port(g), pinned, p, np.zeros(k),
                             tml.MultilevelConfig(engine="torch", device="cpu"))
    assert mlt.agg_decisions() == {}  # off by default
