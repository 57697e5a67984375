"""repro_torch's ell_histogram, fennel_gain and embedding_bag: each plain
version against both JAX routes (the Pallas kernel in interpret mode and
the `kernels/ref.py` oracle), the two places where fennel_gain follows the
oracle rather than the Pallas route, the public ops of
`repro_torch.kernels`, and each wrapper's CPU dispatch and checks.  The
CUDA kernels themselves are tested on a card in test_torch_cuda.py."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.kernels as ref_kernels
from repro.kernels import ops, ref
from repro_torch import kernels
from repro_torch.core.histogram import label_histogram_ell
from repro_torch.graphs import grid_mesh_graph
from repro_torch.kernels import ell_histogram as eh
from repro_torch.kernels import fennel_gain as fg

eb = importlib.import_module("repro_torch.kernels.embedding_bag")
T = torch.from_numpy
J = jnp.asarray

# the shapes of tests/test_kernels.py::test_histogram_shapes, k=1000 too
SHAPES = [(1, 1, 2), (7, 13, 4), (64, 32, 16), (130, 7, 32), (100, 64, 256), (64, 16, 1000)]
# the card kernel's edge shapes: widths outside its specialised ones (8, 16,
# 32, 64), k no multiple of 4 or 32, B no multiple of a block's rows, and a
# clustering-sized label domain
EDGE_SHAPES = [(1001, 8, 30), (333, 24, 2050), (70, 64, 500), (129, 16, 36), (65, 8, 4100),
               (3, 128, 7)]


def _inputs(b, w, k, weights, seed=0):
    rng = np.random.default_rng(seed + 1000 * b + w)
    blk = rng.integers(-1, k, (b, w)).astype(np.int32)
    if weights == "int":
        wts = rng.integers(1, 6, (b, w)).astype(np.float32)
    else:
        wts = rng.random((b, w)).astype(np.float32)
    wts *= blk >= 0
    return blk, wts


def _check(got, want, weights):
    if weights == "int":  # integer sums in float32 are exact in any order
        np.testing.assert_array_equal(got, want)
    else:  # the order of the float32 sums differs
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("weights", ["int", "float"])
@pytest.mark.parametrize("b,w,k", SHAPES + EDGE_SHAPES)
def test_plain_matches_jax_oracle(b, w, k, weights):
    blk, wts = _inputs(b, w, k, weights)
    got = eh.ell_histogram_plain(torch.from_numpy(blk), torch.from_numpy(wts), k)
    want = ref.ell_histogram_ref(jnp.asarray(blk), jnp.asarray(wts), k)
    assert got.shape == (b, k) and got.dtype == torch.float32
    _check(got.numpy(), np.asarray(want), weights)


@pytest.mark.parametrize("weights", ["int", "float"])
@pytest.mark.parametrize("b,w,k", SHAPES)
def test_plain_matches_pallas_kernel_interpreted(b, w, k, weights):
    blk, wts = _inputs(b, w, k, weights, seed=1)
    got = eh.ell_histogram_plain(torch.from_numpy(blk), torch.from_numpy(wts), k)
    want = ops.block_histogram(jnp.asarray(blk), jnp.asarray(wts), k,
                               use_kernel=True, interpret=True)
    _check(got.numpy(), np.asarray(want), weights)


def test_wrapper_takes_plain_version_on_cpu_without_launching():
    blk, wts = _inputs(130, 7, 32, "float")
    before = eh.launches
    got = eh.block_histogram(torch.from_numpy(blk), torch.from_numpy(wts), 32)
    assert eh.launches == before
    want = eh.ell_histogram_plain(torch.from_numpy(blk), torch.from_numpy(wts), 32)
    assert torch.equal(got, want)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    blk, wts = _inputs(8, 8, 4, "int")
    b, w = torch.from_numpy(blk), torch.from_numpy(wts)
    with pytest.raises(TypeError):
        eh.block_histogram(b.long(), w, 4)
    with pytest.raises(TypeError):
        eh.block_histogram(b, w.double(), 4)
    with pytest.raises(ValueError):
        eh.block_histogram(b[:, :4], w, 4)
    with pytest.raises(ValueError):
        eh.block_histogram(b.t(), w.t(), 4)  # not contiguous
    with pytest.raises(ValueError):
        eh.block_histogram(b, w, -1)


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card error path cannot be shown")
    g = grid_mesh_graph(4)
    labels = np.arange(g.n) % 3
    with pytest.raises(RuntimeError, match="no CUDA device"):
        label_histogram_ell(g, labels, device="cuda")
    counts, uniq = label_histogram_ell(g, labels, device="cpu")
    assert counts.shape == (g.n, 3) and list(uniq) == [0, 1, 2]


# ---------------------------------------------------------- fennel gain

# tests/test_kernels.py::test_fennel_gain's shapes, then k past one label
# tile of the kernel and a W of one
FENNEL_SHAPES = [(4, 5, 3), (33, 17, 8), (128, 40, 64), (16, 8, 100), (9, 1, 5)]
ROUTES = ["pallas", "oracle"]


def _jax_fennel(route, blk, wts, loads, node_w, **kw):
    args = (J(blk), J(wts), J(loads), J(node_w))
    if route == "pallas":
        best, score = ops.fennel_choose_batch(*args, use_kernel=True, interpret=True, **kw)
    else:
        best, score = ref.fennel_gain_ref(*args, **kw)
    return np.asarray(best), np.asarray(score)


def _fennel_inputs(b, w, k, seed):
    rng = np.random.default_rng(seed)
    blk = rng.integers(-1, k, (b, w)).astype(np.int32)
    wts = (rng.random((b, w)) * (blk >= 0)).astype(np.float32)
    loads = (rng.random(k) * 10).astype(np.float32)
    node_w = np.ones(b, np.float32)
    return blk, wts, loads, node_w


@pytest.mark.parametrize("gamma", [1.5, 2.0, 3.0])
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("b,w,k", FENNEL_SHAPES)
def test_fennel_plain_matches_jax_routes(b, w, k, route, gamma):
    blk, wts, loads, node_w = _fennel_inputs(b, w, k, seed=b * w + k)
    kw = dict(alpha=0.4, gamma=gamma, cap=11.0)  # loads up to 10: some blocks infeasible
    want_best, want_score = _jax_fennel(route, blk, wts, loads, node_w, **kw)
    before = fg.launches
    best, score = fg.fennel_choose_batch(T(blk), T(wts), T(loads), T(node_w), **kw)
    assert fg.launches == before  # CPU tensors take the plain version
    assert best.dtype == torch.int32 and score.dtype == torch.float32
    np.testing.assert_array_equal(best.numpy(), want_best)
    np.testing.assert_allclose(score.numpy(), want_score, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("route", ROUTES)
def test_fennel_infeasible_fallback_is_least_loaded(route):
    """tests/test_kernels.py::test_fennel_gain_infeasible_fallback: every
    block over cap -> the least-loaded block, on both routes and the port."""
    blk = np.zeros((8, 4), np.int32)
    wts = np.ones((8, 4), np.float32)
    loads = np.array([5.0, 3.0, 4.0], np.float32)
    node_w = np.ones(8, np.float32)
    kw = dict(alpha=0.1, gamma=1.5, cap=2.0)
    want, _ = _jax_fennel(route, blk, wts, loads, node_w, **kw)
    best, score = fg.fennel_choose_batch(T(blk), T(wts), T(loads), T(node_w), **kw)
    assert (want == 1).all()
    np.testing.assert_array_equal(best.numpy(), want)
    assert bool(torch.isneginf(score).all())


def test_fennel_infeasible_score_is_minus_inf_like_the_oracle():
    """Route difference 1: with no feasible block the oracle's score is
    -inf, the Pallas kernel's -1e30; the port follows the oracle."""
    blk, wts, _, node_w = _fennel_inputs(16, 6, 4, seed=3)
    loads = np.array([7.0, 5.0, 9.0, 6.0], np.float32)
    kw = dict(alpha=0.2, gamma=1.5, cap=4.0)
    _, oracle = _jax_fennel("oracle", blk, wts, loads, node_w, **kw)
    _, pallas = _jax_fennel("pallas", blk, wts, loads, node_w, **kw)
    best, score = fg.fennel_choose_batch(T(blk), T(wts), T(loads), T(node_w), **kw)
    assert np.isneginf(oracle).all()
    assert (pallas == np.float32(-1e30)).all()
    np.testing.assert_array_equal(score.numpy(), oracle)
    assert (best.numpy() == 1).all()


def test_fennel_fallback_stays_among_the_real_blocks_like_the_oracle():
    """Route difference 2: when every real load exceeds 2*cap + 1, the
    Pallas route's padded loads win the argmin and it returns block k,
    which does not exist; the oracle and the port return the least-loaded
    real block."""
    blk = np.zeros((8, 4), np.int32)
    wts = np.ones((8, 4), np.float32)
    loads = np.array([50.0, 30.0, 40.0], np.float32)  # 2 * cap + 1 = 5
    node_w = np.ones(8, np.float32)
    kw = dict(alpha=0.1, gamma=1.5, cap=2.0)
    oracle, _ = _jax_fennel("oracle", blk, wts, loads, node_w, **kw)
    pallas, _ = _jax_fennel("pallas", blk, wts, loads, node_w, **kw)
    best, _ = fg.fennel_choose_batch(T(blk), T(wts), T(loads), T(node_w), **kw)
    assert (pallas == 3).all()
    assert (oracle == 1).all()
    np.testing.assert_array_equal(best.numpy(), oracle)


@pytest.mark.parametrize("route", ROUTES)
def test_fennel_matches_sequential_choice(route):
    """tests/test_kernels.py::test_fennel_gain_matches_sequential_choice:
    with frozen loads the wavefront choice equals `fennel_choose` per row,
    the reference's and the port's."""
    from repro.core.fennel import FennelParams, fennel_choose
    from repro.graphs import rmat_graph
    from repro_torch.core import fennel as port_fennel

    g = rmat_graph(64, 4, seed=5)
    k = 4
    block = np.arange(g.n) % k
    block[32:] = -1
    p = FennelParams(k=k, n_total=float(g.n), m_total=g.total_edge_weight(), eps=0.5)
    pp = port_fennel.FennelParams(k=k, n_total=float(g.n), m_total=g.total_edge_weight(),
                                  eps=0.5)
    loads = np.bincount(block[block >= 0], minlength=k).astype(np.float64)
    nodes = np.arange(32, 48)
    nbr, wts, mask = g.ell_block(nodes)
    nbr_blk = np.where(mask, block[np.clip(nbr, 0, g.n - 1)], -1).astype(np.int32)
    kw = dict(alpha=p.alpha, gamma=p.gamma, cap=p.cap)
    args = (nbr_blk, wts.astype(np.float32), loads.astype(np.float32),
            g.node_w[nodes].astype(np.float32))
    want_route, _ = _jax_fennel(route, *args, **kw)
    best, _ = fg.fennel_choose_batch(*map(T, args), **kw)
    np.testing.assert_array_equal(best.numpy(), want_route)
    for i, v in enumerate(nodes):
        nb, nw = g.neighbors(int(v)), g.neighbor_weights(int(v))
        want = fennel_choose(nb, nw, float(g.node_w[v]), block, loads, p)
        assert int(best[i]) == want, (v, int(best[i]), want)
        assert port_fennel.fennel_choose(nb, nw, float(g.node_w[v]), block, loads, pp) == want


def test_fennel_penalty_matches_reference_formula():
    loads = np.array([-1.0, 0.0, 0.5, 3.0, 17.25], np.float32)
    for gamma in (1.25, 1.5, 2.0, 2.5, 3.0):
        got = fg.fennel_penalty_plain(T(loads), 0.3, gamma)
        want = 0.3 * gamma * jnp.power(jnp.maximum(J(loads), 0.0), gamma - 1.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


def test_fennel_wrapper_rejects_what_the_kernel_does_not_take():
    blk, wts, loads, node_w = (T(a) for a in _fennel_inputs(8, 4, 3, seed=0))
    kw = dict(alpha=0.1, gamma=1.5, cap=5.0)
    with pytest.raises(TypeError):
        fg.fennel_choose_batch(blk.long(), wts, loads, node_w, **kw)
    with pytest.raises(TypeError):
        fg.fennel_choose_batch(blk, wts.double(), loads, node_w, **kw)
    with pytest.raises(ValueError):
        fg.fennel_choose_batch(blk, wts[:, :2], loads, node_w, **kw)
    with pytest.raises(ValueError):
        fg.fennel_choose_batch(blk, wts, loads[:0], node_w, **kw)  # k = 0
    with pytest.raises(ValueError):
        fg.fennel_choose_batch(blk, wts, loads, node_w[:3], **kw)
    with pytest.raises(ValueError):
        fg.fennel_choose_batch(blk.t(), wts.t(), loads, T(np.ones(4, np.float32)), **kw)
    # float64 loads and node weights are taken in float32, as the reference's kernel route does
    best, _ = fg.fennel_choose_batch(blk, wts, loads.double(), node_w.double(), **kw)
    np.testing.assert_array_equal(best, fg.fennel_choose_batch(blk, wts, loads, node_w, **kw)[0])


# -------------------------------------------------------- embedding bag

# tests/test_kernels.py::test_embedding_bag's shapes
BAG_SHAPES = [(16, 8, 4, 1), (64, 96, 32, 5), (128, 128, 16, 3), (32, 200, 8, 7)]


def _bag_inputs(v, d, b, l, seed, lead=()):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((*lead, v, d)).astype(np.float32)
    idx = rng.integers(0, v, (b, *lead, l)).astype(np.int32)
    mask = (rng.random((b, *lead, l)) > 0.3).astype(np.float32)
    return table, idx, mask


def _jax_bag(route, table, idx, mask):
    if route == "pallas":
        return np.asarray(ops.embedding_bag(J(table), J(idx), J(mask), use_kernel=True,
                                            interpret=True))
    return np.asarray(ref.embedding_bag_ref(J(table), J(np.clip(idx, 0, table.shape[0] - 1)),
                                            J(mask)))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("v,d,b,l", BAG_SHAPES)
def test_bag_plain_matches_jax_routes(v, d, b, l, route):
    table, idx, mask = _bag_inputs(v, d, b, l, seed=v + d)
    before = eb.launches
    got = eb.embedding_bag(T(table), T(idx), T(mask))
    assert eb.launches == before  # CPU tensors take the plain version
    assert got.shape == (b, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _jax_bag(route, table, idx, mask),
                               rtol=1e-6, atol=1e-6)


@given(st.integers(2, 40), st.integers(1, 6), st.integers(0, 2**31 - 1))
@settings(max_examples=15, deadline=None)
def test_bag_property(v, l, seed):
    """tests/test_kernels.py::test_embedding_bag_property, with the port's
    plain version beside the Pallas route."""
    rng = np.random.default_rng(seed)
    d, b = 16, 8
    table = rng.standard_normal((v, d)).astype(np.float32)
    idx = rng.integers(0, v, (b, l)).astype(np.int32)
    mask = np.ones((b, l), np.float32)
    got = eb.embedding_bag(T(table), T(idx), T(mask)).numpy()
    np.testing.assert_allclose(got, table[idx].sum(1), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, _jax_bag("pallas", table, idx, mask), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("route", ROUTES)
def test_bag_clamps_out_of_range_indices_like_the_reference(route):
    table, idx, mask = _bag_inputs(10, 8, 6, 3, seed=4)
    idx[0, 0], idx[1, 2], idx[2, 1], idx[3, 0] = -1, 10, -7, 2**31 - 1
    got = eb.embedding_bag(T(table), T(idx), T(mask)).numpy()
    np.testing.assert_allclose(got, _jax_bag(route, table, idx, mask), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("route", ROUTES)
def test_stacked_bag_matches_vmap_over_tables(route):
    """The stacked form equals jax.vmap of the 2-D op over the tables, the
    way repro/models/dlrm.py pools its 26 features."""
    t, v, d, b, l = 5, 24, 16, 12, 2
    table, idx, mask = _bag_inputs(v, d, b, l, seed=9, lead=(t,))
    idx[0, 1, 0], idx[3, 4, 1] = -1, v
    lookup = jax.vmap(
        lambda tab, i, m: ops.embedding_bag(tab, i, m, use_kernel=route == "pallas",
                                            interpret=True),
        in_axes=(0, 1, 1), out_axes=1)
    want = np.asarray(lookup(J(table), J(idx), J(mask)))
    got = eb.embedding_bag(T(table), T(idx), T(mask))
    assert got.shape == (b, t, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # each table's slice is the 2-D op on that table
    for j in range(t):
        assert torch.equal(got[:, j], eb.embedding_bag(T(table[j]), T(idx[:, j].copy()),
                                                       T(mask[:, j].copy())))


def test_bag_wrapper_rejects_what_the_kernel_does_not_take():
    table, idx, mask = (T(a) for a in _bag_inputs(16, 8, 4, 2, seed=0))
    with pytest.raises(TypeError):
        eb.embedding_bag(table.double(), idx, mask)
    with pytest.raises(TypeError):
        eb.embedding_bag(table, idx.long(), mask)
    with pytest.raises(ValueError):
        eb.embedding_bag(table, idx, mask[:, :1])
    with pytest.raises(ValueError):
        eb.embedding_bag(table[:0], idx, mask)  # no rows to clamp to
    with pytest.raises(ValueError):
        eb.embedding_bag(table[None].expand(3, 16, 8).contiguous(), idx[:, None], mask[:, None])
    with pytest.raises(ValueError):
        eb.embedding_bag(table.t(), idx, mask)  # not contiguous


# ---------------------------------------------------------- public ops

def test_public_ops_are_the_references_four():
    assert sorted(kernels.__all__) == sorted(ref_kernels.__all__)
    assert kernels.block_histogram is eh.block_histogram
    assert kernels.fennel_choose_batch is fg.fennel_choose_batch
    assert kernels.embedding_bag is eb.embedding_bag
    from repro_torch.kernels import swa_attention as sw
    assert kernels.swa_attention_decode is sw.swa_attention_decode
    from repro_torch.kernels import _build
    assert set(_build.SOURCES) == {"ell_histogram", "fennel_gain", "embedding_bag",
                                   "swa_attention", "csr_pack"}
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").exists()


def test_public_ops_match_the_references_public_ops():
    blk, wts = _inputs(33, 9, 8, "float", seed=2)
    np.testing.assert_allclose(
        kernels.block_histogram(T(blk), T(wts), 8).numpy(),
        np.asarray(ref_kernels.block_histogram(J(blk), J(wts), 8, use_kernel=False)), rtol=1e-6)
    blk, wts, loads, node_w = _fennel_inputs(33, 9, 8, seed=2)
    kw = dict(alpha=0.4, gamma=1.5, cap=11.0)
    best, _ = kernels.fennel_choose_batch(T(blk), T(wts), T(loads), T(node_w), **kw)
    want, _ = ref_kernels.fennel_choose_batch(J(blk), J(wts), J(loads), J(node_w),
                                              use_kernel=False, **kw)
    np.testing.assert_array_equal(best.numpy(), np.asarray(want))
    table, idx, mask = _bag_inputs(20, 12, 7, 3, seed=2)
    np.testing.assert_allclose(
        kernels.embedding_bag(T(table), T(idx), T(mask)).numpy(),
        np.asarray(ref_kernels.embedding_bag(J(table), J(idx), J(mask), use_kernel=False)),
        rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------- fennel sweep

def _sweep_inputs(n=40, k=5, seed=0):
    """A small src-sorted level with its sweep arguments, as
    `multilevel_torch._initial_fennel` prepares them."""
    rng = np.random.default_rng(seed)
    n_pad, e = 64, 160
    src = np.sort(rng.integers(0, n, e))
    e_pad = 256
    esrc, edst = np.full(e_pad, n_pad), np.full(e_pad, n_pad)
    esrc[:e], edst[:e] = src, rng.integers(0, n, e)
    ew = np.zeros(e_pad)
    ew[:e] = rng.integers(0, 3, e)
    node_w = np.zeros(n_pad)
    node_w[:n] = rng.integers(1, 3, n)
    labels = np.full(n_pad, -1)
    labels[:8] = rng.integers(0, k, 8)
    order = np.concatenate([np.arange(8, n), np.arange(8), np.arange(n, n_pad)])
    indptr = np.searchsorted(esrc, np.arange(n_pad + 1))
    loads = np.bincount(labels[:8], weights=node_w[:8], minlength=k).astype(np.float64)
    return [T(a) for a in (esrc, edst, ew, node_w, order, indptr, labels, loads)], n - 8


def test_fennel_sweep_takes_plain_version_on_cpu_without_launching():
    args, n_free = _sweep_inputs()
    kw = dict(alpha=0.5, gamma=1.5, cap=40.0, w_c=64)
    kept = [a.clone() for a in args]
    before = fg.sweep_launches
    labels, loads = fg.fennel_sweep(*args, n_free, **kw)
    assert fg.sweep_launches == before
    want = fg.fennel_sweep_plain(*args, n_free, **kw)
    assert torch.equal(labels, want[0]) and torch.equal(loads, want[1])
    assert all(torch.equal(a, b) for a, b in zip(args, kept))  # inputs left as they were
    assert bool((labels[:40] >= 0).all()) and float(loads.sum()) == float(args[3].sum())


def test_fennel_sweep_rejects_what_the_kernel_does_not_take():
    args, n_free = _sweep_inputs()
    kw = dict(alpha=0.5, gamma=1.5, cap=40.0, w_c=64)
    for i, bad in ((1, args[1].int()), (2, args[2].float()), (5, args[5][:-1]),
                   (6, args[6][:-1]), (7, args[7][:0])):
        broken = list(args)
        broken[i] = bad
        with pytest.raises((TypeError, ValueError)):
            fg.fennel_sweep(*broken, n_free, **kw)
    with pytest.raises(ValueError):
        fg.fennel_sweep(*args, 1000, **kw)  # more steps than nodes in order
