"""repro_torch on a CUDA card: the ell_histogram, swa_attention,
embedding_bag and fennel_gain kernels (the public op's and the V-cycle's
initial sweep) against their plain versions, DLRM forwards through the bag
kernel, the device engines against the port's host `sparse` engine, the
pipelined driver's worker thread on the caller's stream, and the
out-of-core path on the device engine: a disk stream against the graph in
memory, resume from a snapshot, and a restream pass with an exact cut;
the sweep kernel on fractional edge weights and on levels whose order
steps from node to neighbour (and its stamped copy); the front door
(`repro_torch.api.partition`) with BuffCut and HeiStream on the card; the
GNN path: GraphSAGE's sampled loss and gradients, segment_mean and every
GNN arch's first full-preset step on the card against the CPU, BuffCut
placement on the card against the host, and the bag refusing a table
that requires grad; the MoE layer on the card against the CPU (ties
included) and rerun bit for bit, and every LM arch's and DLRM's first
smoke train step on the card against the CPU; the device mesh on a world
of one (NCCL): the expert-parallel MoE against the one-device MoE, the
DLRM serve cell against `dlrm_forward` with the bag launched from the
cell, and the halo GraphSAGE loss against `sage_loss`.

Every test is marked `cuda` and skips without a card.  The file imports
neither jax nor the JAX package, so it runs on a machine that has only
PyTorch:  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import importlib

import numpy as np
import pytest
import torch

import repro_torch.core.multilevel_torch as mlt
from repro_torch.configs import dlrm_mlperf
from repro_torch.core.batch_model import build_batch_model
from repro_torch.core.fennel import FennelParams
from repro_torch.core.multilevel import MultilevelConfig, multilevel_partition
from repro_torch.graphs import grid_mesh_graph, rmat_graph
from repro_torch.graphs.csr import bucket_size
from repro_torch.kernels import ell_histogram as eh
from repro_torch.kernels import fennel_gain as fg
from repro_torch.kernels import swa_attention as sw
from repro_torch.launch.serve import serve_dlrm
from repro_torch.models import dlrm
from _sweep_levels import KINDS, chained_level

eb = importlib.import_module("repro_torch.kernels.embedding_bag")

pytestmark = pytest.mark.cuda

# (B, W, k): the reference's test shapes, the main path's, then widths
# outside the specialised ones, k no multiple of 4 or 32, B no multiple of a
# block's rows, and a clustering-sized k = n_pad
SHAPES = [(1, 1, 2), (7, 13, 4), (64, 32, 16), (130, 7, 32), (100, 64, 256),
          (64, 16, 1000), (65536, 8, 32), (4096, 64, 4096), (1001, 8, 30), (333, 24, 2050),
          (70, 64, 5000), (517, 8, 32800), (129, 16, 36)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("b,w,k", SHAPES)
def test_kernel_matches_plain_on_card(b, w, k, card):
    rng = np.random.default_rng(b + w + k)
    blk = rng.integers(-1, k, (b, w)).astype(np.int32)
    blk[::3, ::2] = blk[::3, :1]  # repeated labels within a row
    for wts in (rng.integers(1, 6, (b, w)), rng.random((b, w))):
        wts = (wts * (blk >= 0)).astype(np.float32)
        blk_c, wts_c = torch.from_numpy(blk).to(card), torch.from_numpy(wts).to(card)
        before = eh.launches
        got = eh.block_histogram(blk_c, wts_c, k)
        assert eh.launches == before + 1
        # the plain version repeats the kernel's float32 adds in w order
        assert torch.equal(got, eh.ell_histogram_plain(blk_c, wts_c, k))
        assert torch.equal(got, eh.block_histogram(blk_c, wts_c, k))  # a second launch


# (B, S, KVH, G, D, window, pos): ragged pos past the window, pos = 0, a
# window wider than the cache, D = 64 and 128, G = 1; then windows that
# cross split boundaries: a window no multiple of the chunk with one empty
# row among full ones, pos in the middle of a chunk, ragged rows whose later
# splits are empty, and G = 16 over a window of 8192 (64 splits of 128)
SWA_SHAPES = [(4, 700, 8, 4, 80, 256, (600, 300, 256, 3)), (3, 64, 8, 4, 80, 4096, (0, 0, 0)),
              (2, 100, 2, 4, 80, 4096, (100, 60)), (2, 300, 4, 4, 64, 128, (300, 7)),
              (2, 300, 4, 4, 128, 128, (250, 129)), (2, 300, 8, 1, 80, 64, (300, 1)),
              (3, 3000, 8, 4, 80, 2500, (3000, 0, 2999)),
              (4, 700, 8, 4, 80, 300, (700, 333, 129, 650)),
              (4, 5000, 2, 4, 80, 4096, (5000, 4100, 1000, 70)),
              (1, 8192, 1, 16, 128, 8192, (8192,))]


def _swa_inputs(b, s, kvh, g, d, pos, dtype, card):
    gen = torch.Generator(device=card).manual_seed(b * s + d)
    q, k, v = (torch.randn(shape, generator=gen, device=card).to(dtype)
               for shape in ((b, kvh, g, d), (b, s, kvh, d), (b, s, kvh, d)))
    return q, k, v, torch.tensor(pos, dtype=torch.int32, device=card)


@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 1e-5, 1e-5),
                                             (torch.bfloat16, 8e-3, 1e-3)])
@pytest.mark.parametrize("b,s,kvh,g,d,window,pos", SWA_SHAPES)
def test_swa_kernel_matches_plain_on_card(b, s, kvh, g, d, window, pos, dtype, rtol, atol,
                                          card):
    q, k, v, p = _swa_inputs(b, s, kvh, g, d, pos, dtype, card)
    before = sw.launches
    got = sw.swa_attention_decode(q, k, v, p, window=window)
    assert sw.launches == before + 1
    torch.testing.assert_close(got, sw.swa_attention_decode_plain(q, k, v, p, window=window),
                               rtol=rtol, atol=atol)
    if max(pos) == 0:
        assert not got.any()
    # fixed reduction order, no atomics: a second launch is bit-identical
    assert torch.equal(got, sw.swa_attention_decode(q, k, v, p, window=window))


@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 1e-5, 1e-5),
                                             (torch.bfloat16, 8e-3, 1e-3)])
def test_swa_kernel_decode_32k_plan_at_two_rows(dtype, rtol, atol, card, monkeypatch):
    """decode_32k's plan (4 splits of 1024 over a 32768-row cache, what 1024
    rows get on 132 SMs) at B = 2, with 64-bit offsets into the cache."""
    monkeypatch.setattr(sw, "_sm_count", lambda index: 16)
    assert sw.split_plan(4096, 16, 4, sw._sm_count(0)) == (4, 1024)
    q, k, v, p = _swa_inputs(2, 32768, 8, 4, 80, (32768, 30000), dtype, card)
    got = sw.swa_attention_decode(q, k, v, p, window=4096)
    torch.testing.assert_close(got, sw.swa_attention_decode_plain(q, k, v, p, window=4096),
                               rtol=rtol, atol=atol)
    assert torch.equal(got, sw.swa_attention_decode(q, k, v, p, window=4096))


def test_swa_kernel_refuses_what_it_cannot_run(card):
    # G = 16 over a window of 8192 was refused for shared memory by the
    # unsplit kernel; the split kernel keeps only a chunk's scores and runs it
    q, k, v, p = _swa_inputs(1, 8192, 1, 16, 128, (8192,), torch.float32, card)
    torch.testing.assert_close(sw.swa_attention_decode(q, k, v, p, window=8192),
                               sw.swa_attention_decode_plain(q, k, v, p, window=8192),
                               rtol=1e-5, atol=1e-5)
    # G = 17 and D·itemsize = 120 bytes were refused; the wrapper now splits
    # the query heads and pads D, and both agree with the plain version
    for g, d, dtype, rtol, atol in ((17, 64, torch.float32, 1e-5, 1e-5),
                                    (2, 60, torch.bfloat16, 8e-3, 1e-3)):
        q, k, v, p = _swa_inputs(1, 16, 1, g, d, (8,), dtype, card)
        torch.testing.assert_close(sw.swa_attention_decode(q, k, v, p, window=8),
                                   sw.swa_attention_decode_plain(q, k, v, p, window=8),
                                   rtol=rtol, atol=atol)
    q, k, v, p = _swa_inputs(1, 16, 1, 2, 64, (8,), torch.float32, card)
    with pytest.raises(ValueError, match="int32"):
        sw.swa_attention_decode(q, k, v, torch.tensor([2**31], device=card), window=8)


# (B, S, KVH, G, D, window, pos, dtype): what the reference's op takes and
# the kernel alone does not: G = 32 (two launches of 16), D = 36 in bf16
# (72 bytes, padded to 80), D = 36 in float32 (144 bytes, unpadded), and G
# = 20 with D = 20 in bf16 (both at once)
SWA_GENERAL = [(2, 600, 2, 32, 64, 256, (600, 300), torch.float32),
               (2, 600, 2, 32, 80, 256, (600, 31), torch.bfloat16),
               (3, 500, 4, 4, 36, 128, (500, 200, 5), torch.bfloat16),
               (3, 500, 4, 4, 36, 128, (500, 200, 5), torch.float32),
               (2, 300, 2, 20, 20, 300, (300, 100), torch.bfloat16)]
SWA_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (8e-3, 1e-3)}


@pytest.mark.parametrize("b,s,kvh,g,d,window,pos,dtype", SWA_GENERAL)
def test_swa_kernel_general_shapes_match_plain(b, s, kvh, g, d, window, pos, dtype, card):
    q, k, v, p = _swa_inputs(b, s, kvh, g, d, pos, dtype, card)
    rtol, atol = SWA_TOL[dtype]
    before = sw.launches
    got = sw.swa_attention_decode(q, k, v, p, window=window)
    assert sw.launches == before + -(-g // 16)
    assert got.shape == q.shape and got.dtype == dtype
    torch.testing.assert_close(got, sw.swa_attention_decode_plain(q, k, v, p, window=window),
                               rtol=rtol, atol=atol)
    assert torch.equal(got, sw.swa_attention_decode(q, k, v, p, window=window))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swa_kernel_takes_strided_tensors_and_int64_pos(dtype, card):
    """Non-contiguous q and caches (views of wider tensors), a cache view
    16-byte misaligned, and an int64 pos, against the plain version on
    contiguous copies."""
    b, s, kvh, g, d = 3, 400, 4, 4, 64
    gen = torch.Generator(device=card).manual_seed(7)
    q_wide = torch.randn((b, g, kvh, d), generator=gen, device=card).to(dtype)
    q = q_wide.transpose(1, 2)  # (B, KVH, G, D), not contiguous
    kv = torch.randn((2, b, s, kvh, d + 1), generator=gen, device=card).to(dtype)
    k, v = kv[0, ..., 1:], kv[1, ..., :d]  # strided; k starts one element in
    pos = torch.tensor([400, 123, 7], dtype=torch.int64, device=card)
    assert not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous())
    rtol, atol = SWA_TOL[dtype]
    got = sw.swa_attention_decode(q, k, v, pos, window=256)
    want = sw.swa_attention_decode_plain(q.contiguous(), k.contiguous(), v.contiguous(),
                                         pos.to(torch.int32), window=256)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    # contiguous but 16-byte misaligned: a view one element into its storage
    flat = torch.randn(b * s * kvh * d + 1, generator=gen, device=card).to(dtype)
    k_off = flat[1:].view(b, s, kvh, d)
    assert k_off.is_contiguous() and k_off.data_ptr() % 16
    got = sw.swa_attention_decode(q, k_off, v, pos, window=256)
    want = sw.swa_attention_decode_plain(q.contiguous(), k_off.contiguous(), v.contiguous(),
                                         pos.to(torch.int32), window=256)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


def _batch_model(g, k=8):
    rng = np.random.default_rng(0)
    block = np.full(g.n, -1, dtype=np.int64)
    block[:200] = rng.integers(0, k, 200)
    loads = np.bincount(block[:200], weights=g.node_w[:200], minlength=k).astype(np.float64)
    model = build_batch_model(g, np.arange(200, 420), block, k)
    p = FennelParams(k=k, n_total=float(g.node_w.sum()), m_total=g.total_edge_weight(),
                     eps=0.05)
    return model, p, loads


@pytest.mark.parametrize("graph", ["rmat", "grid"])
@pytest.mark.parametrize("engine,mode", [("torch", None), ("torch", "dense"), ("torch", "sort"),
                                         ("torch", "ell"), ("ell", None), ("auto", None)])
def test_engines_on_card_match_host_sparse(graph, engine, mode, card, monkeypatch):
    g = rmat_graph(512, 8, seed=3) if graph == "rmat" else grid_mesh_graph(24)
    model, p, loads = _batch_model(g)
    want = multilevel_partition(model.graph, model.pinned_block, p, loads,
                                MultilevelConfig(engine="sparse", device="cpu"))
    monkeypatch.setattr(mlt, "MODE_OVERRIDE", mode)
    before = fg.sweep_launches
    got = multilevel_partition(model.graph, model.pinned_block, p, loads,
                               MultilevelConfig(engine=engine, device=str(card)))
    np.testing.assert_array_equal(got, want)
    # the device V-cycle runs its initial sweep in one kernel launch
    assert fg.sweep_launches == before + (engine == "torch")


@pytest.mark.parametrize("gamma", [1.25, 2.5])
def test_device_engine_matches_host_at_other_gammas(gamma, card):
    """gamma outside {1.5, 2, 3}: the device penalty takes CUDA's pow and
    the host numpy's (libm); the labels are still the same."""
    import dataclasses

    model, p, loads = _batch_model(rmat_graph(512, 8, seed=3))
    p = dataclasses.replace(p, gamma=gamma)
    want = multilevel_partition(model.graph, model.pinned_block, p, loads,
                                MultilevelConfig(engine="sparse", device="cpu"))
    before = fg.sweep_launches
    got = multilevel_partition(model.graph, model.pinned_block, p, loads,
                               MultilevelConfig(engine="torch", device=str(card)))
    np.testing.assert_array_equal(got, want)
    assert fg.sweep_launches == before + 1


# (T or None for the 2-D form, V, D, B, L): the reference's test shapes, a D
# that takes 4-byte loads, DLRM's smoke and serve widths, and L = 0
BAG_SHAPES = [(None, 16, 8, 4, 1), (None, 64, 96, 32, 5), (None, 128, 128, 16, 3),
              (None, 32, 200, 8, 7), (None, 50, 7, 9, 2), (4, 128, 16, 16, 2),
              (26, 4096, 128, 512, 1), (26, 4096, 128, 300, 2), (3, 10, 128, 5, 0)]


def _bag_inputs(t, v, d, b, l, card, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)
    lead = () if t is None else (t,)
    table = torch.randn((*lead, v, d), generator=gen, device=card)
    idx = torch.randint(-2, v + 2, (b, *lead, l), generator=gen, device=card,
                        dtype=torch.int32)  # a few out of range: they clamp
    mask = (torch.rand((b, *lead, l), generator=gen, device=card) > 0.3).float()
    return table, idx, mask * torch.rand((b, *lead, l), generator=gen, device=card)


@pytest.mark.parametrize("t,v,d,b,l", BAG_SHAPES)
def test_bag_kernel_matches_plain_on_card(t, v, d, b, l, card):
    table, idx, mask = _bag_inputs(t, v, d, b, l, card, seed=v + d)
    before = eb.launches
    got = eb.embedding_bag(table, idx, mask)
    assert eb.launches == before + 1
    # the plain version repeats the kernel's multiply-then-add in l order
    assert torch.equal(got, eb.embedding_bag_plain(table, idx, mask))
    assert torch.equal(got, eb.embedding_bag(table, idx, mask))  # a second launch


def test_bag_kernel_unaligned_table_takes_scalar_loads(card):
    table, idx, mask = _bag_inputs(None, 33, 128, 16, 2, card)
    flat = torch.empty(33 * 128 + 1, device=card)
    shifted = flat[1:].view(33, 128)  # 4 bytes past a 16-byte boundary
    shifted.copy_(table)
    assert torch.equal(eb.embedding_bag(shifted, idx, mask),
                       eb.embedding_bag_plain(table, idx, mask))


def test_bag_kernel_at_full_width_needs_64_bit_offsets(card):
    """26 stacked 2^20 x 128 tables hold 3.49e9 floats: table 16 on starts
    past 2^31 elements."""
    cfg = dlrm_mlperf.full_config()
    t, v, d = cfg.n_sparse, cfg.vocab_size, cfg.embed_dim
    table = torch.empty((t, v, d), device=card)
    rows = torch.arange(t, device=card, dtype=torch.float32)[:, None] * 10 + torch.arange(
        d, device=card, dtype=torch.float32)
    table[:, v - 1] = rows  # the last row of every table is known
    idx = torch.full((4, t, 1), v - 1, dtype=torch.int32, device=card)
    idx[1] = v + 5  # clamps to the last row too
    got = eb.embedding_bag(table, idx, torch.ones((4, t, 1), device=card))
    assert torch.equal(got, rows.expand(4, t, d))


# (B, W, k, weights, gamma): the public op's timed shape with integer
# weights at three gammas, k past a label tile with float weights, W = 0,
# one row
FENNEL_CASES = [(32768, 64, 32, "int", 1.5), (32768, 64, 32, "int", 2.0),
                (32768, 64, 32, "int", 3.0), (4096, 64, 1000, "float", 1.5),
                (33, 17, 8, "float", 1.25), (64, 0, 5, "int", 1.5), (1, 3, 2, "float", 2.5)]


def _fennel_inputs(b, w, k, weights, card, seed=0):
    rng = np.random.default_rng(seed)
    blk = rng.integers(-1, k, (b, w)).astype(np.int32)
    wts = rng.integers(1, 6, (b, w)) if weights == "int" else rng.random((b, w))
    wts = (wts * (blk >= 0)).astype(np.float32)
    loads = (rng.random(k) * 100).astype(np.float32)
    node_w = rng.integers(1, 4, b).astype(np.float32)
    return [torch.from_numpy(a).to(card) for a in (blk, wts, loads, node_w)]


@pytest.mark.parametrize("b,w,k,weights,gamma", FENNEL_CASES)
def test_fennel_kernel_matches_plain_on_card(b, w, k, weights, gamma, card):
    blk, wts, loads, node_w = _fennel_inputs(b, w, k, weights, card, seed=b + w + k)
    kw = dict(alpha=0.05, gamma=gamma, cap=90.0)  # loads up to 100: some infeasible
    before = fg.launches
    best, score = fg.fennel_choose_batch(blk, wts, loads, node_w, **kw)
    assert fg.launches == before + 1
    want_best, want_score = fg.fennel_gain_plain(blk, wts, loads, node_w, **kw)
    assert torch.equal(best, want_best) and torch.equal(score, want_score)
    again = fg.fennel_choose_batch(blk, wts, loads, node_w, **kw)
    assert torch.equal(again[0], best) and torch.equal(again[1], score)


FENNEL_GAMMAS = (1.25, 1.5, 2.0, 2.5, 3.0, 4.0)


@pytest.mark.parametrize("b", [1, 7, 32768])
@pytest.mark.parametrize("w", [1, 6, 63, 64, 256])
@pytest.mark.parametrize("k", [1, 31, 32, 33, 1000])
def test_fennel_kernel_grid_matches_plain_on_card(k, w, b, card):
    """Both kernels (k <= 32 with W a multiple of 4 takes the staged one)
    against the plain version, bit for bit, at every gamma: fractional
    weights, and every third row only -1 entries."""
    blk, wts, loads, node_w = _fennel_inputs(b, w, k, "float", card, seed=k * w + b)
    blk[::3] = -1
    wts[::3] = 0.0
    for gamma in FENNEL_GAMMAS:
        kw = dict(alpha=0.05, gamma=gamma, cap=90.0)
        best, score = fg.fennel_choose_batch(blk, wts, loads, node_w, **kw)
        want_best, want_score = fg.fennel_gain_plain(blk, wts, loads, node_w, **kw)
        assert torch.equal(best, want_best), gamma
        assert torch.equal(score, want_score), gamma


def test_fennel_kernel_all_infeasible_falls_back_to_least_loaded(card):
    blk, wts, _, node_w = _fennel_inputs(500, 8, 40, "int", card)
    loads = torch.full((40,), 80.0, device=card)
    loads[[7, 30]] = 60.0  # the first minimum is block 7
    best, score = fg.fennel_choose_batch(blk, wts, loads, node_w, alpha=0.1, gamma=1.5, cap=50.0)
    assert bool((best == 7).all()) and bool(torch.isneginf(score).all())


def test_fennel_kernel_refuses_a_row_past_shared_memory(card):
    """A row of loads and penalty past shared memory (k = 40000: 320 KB) was
    refused; it now stays in device memory and the kernel still equals its
    plain version bit for bit."""
    blk, wts, loads, node_w = _fennel_inputs(8, 4, 40000, "int", card)
    kw = dict(alpha=0.1, gamma=1.5, cap=50.0)
    best, score = fg.fennel_choose_batch(blk, wts, loads, node_w, **kw)
    want_best, want_score = fg.fennel_gain_plain(blk, wts, loads, node_w, **kw)
    assert torch.equal(best, want_best) and torch.equal(score, want_score)


@pytest.mark.parametrize("gamma", [1.5, 2.5])
@pytest.mark.parametrize("w", [16, 6])
def test_fennel_kernel_at_k_65536_matches_plain(w, gamma, card):
    """k = 65,536 blocks (the row in device memory): best and score bit for
    bit, with some rows infeasible, and with no block feasible (the first
    least-loaded block and -inf)."""
    blk, wts, loads, node_w = _fennel_inputs(300, w, 65536, "float", card, seed=w)
    blk[::3] = -1
    wts[::3] = 0.0
    kw = dict(alpha=0.05, gamma=gamma, cap=90.0)
    before = fg.launches
    best, score = fg.fennel_choose_batch(blk, wts, loads, node_w, **kw)
    assert fg.launches == before + 1
    want_best, want_score = fg.fennel_gain_plain(blk, wts, loads, node_w, **kw)
    assert torch.equal(best, want_best) and torch.equal(score, want_score)
    full = torch.full_like(loads, 95.0)
    full[[40000, 60000]] = 91.0
    best, score = fg.fennel_choose_batch(blk, wts, full, node_w, **kw)
    want_best, want_score = fg.fennel_gain_plain(blk, wts, full, node_w, **kw)
    assert bool((best == 40000).all()) and bool(torch.isneginf(score).all())
    assert torch.equal(best, want_best) and torch.equal(score, want_score)


def _sweep_level(n, n_pad, k, n_free, hub, cap_share, seed, fractional=False):
    """A src-sorted level for `_initial_fennel` as numpy arrays: ~4 edges a
    node with integer weights 0-3 (or, `fractional`, weights drawn from
    uniform(0.5, 2.0)), node 5 a free hub of `hub` more edges, `n_free`
    free nodes and the rest pinned, pads past n, and the cap at `cap_share`
    of the average load plus the heaviest node (where that holds less than
    every node, the last steps fall back)."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([np.repeat(np.arange(n), 4), np.full(hub, 5)])
    dst = rng.integers(0, n, src.size)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    by_src = np.argsort(src, kind="stable")
    e = src.size
    e_pad = bucket_size(e)
    esrc, edst = np.full(e_pad, n_pad), np.full(e_pad, n_pad)
    esrc[:e], edst[:e] = src[by_src], dst[by_src]
    ew = np.zeros(e_pad)
    ew[:e] = rng.uniform(0.5, 2.0, e) if fractional else rng.integers(0, 4, e)
    node_w = np.zeros(n_pad)
    node_w[:n] = rng.integers(1, 4, n)
    pinned = np.full(n_pad, -2)
    pinned[:n] = rng.integers(0, k, n)
    free = np.concatenate([[5], rng.choice(np.setdiff1d(np.arange(n), [5]), n_free - 1,
                                           replace=False)])
    pinned[free] = -1
    held = pinned[:n] >= 0
    loads0 = np.bincount(pinned[:n][held], weights=node_w[:n][held], minlength=k)
    cap = cap_share * node_w.sum() / k + 3
    deg = np.bincount(src, minlength=n)
    w_c = min(bucket_size(int(deg[free].max()), minimum=64), e_pad)
    return (esrc, edst, ew, node_w, pinned), n, n_free, loads0.astype(np.float64), cap, w_c


# (n, n_pad, k, n_free, hub, gamma): k around a warp, past it and past
# shared memory's 24·k bytes beside the labels; every gamma; labels past
# shared memory (n_pad = 65536) at k within and past a warp; a hub of 1500
# or 3000 neighbours (past a staged segment's 1024 entries) in every case
SWEEP_CASES = ([(3000, 4096, k, 1500, 3000, 1.5) for k in (2, 31, 32, 33, 64, 257)]
               + [(3000, 4096, 8000, 400, 1500, 1.5)]
               + [(3000, 4096, 32, 1500, 3000, g) for g in (1.25, 2.0, 2.5, 3.0, 4.0)]
               + [(50000, 65536, 32, 600, 3000, 1.5), (50000, 65536, 257, 600, 3000, 2.0)])


def _sweep_on_card_against_plain(n, n_pad, k, n_free, hub, gamma, cap_share, card,
                                 monkeypatch, fractional=False):
    level = _sweep_level(n, n_pad, k, n_free, hub, cap_share, seed=k + n_pad,
                         fractional=fractional)
    return _sweep_check(level, gamma, card, monkeypatch)


def _sweep_check(level, gamma, card, monkeypatch):
    """`_initial_fennel` on the card (one sweep launch) against the plain
    sweep on the arguments it prepared; returns those arguments and the
    labels and loads."""
    arrays, n, n_free, loads0, cap, w_c = level
    k = loads0.shape[0]
    seen = {}

    def record(*a, **kw):
        seen["args"], seen["kw"] = a, kw
        return fg.fennel_sweep(*a, **kw)

    monkeypatch.setattr(mlt, "fennel_sweep", record)
    before = fg.sweep_launches
    labels, loads = mlt._initial_fennel(*(torch.from_numpy(a).to(card) for a in arrays), n,
                                        n_free, torch.from_numpy(loads0).to(card), 0.3, gamma,
                                        cap, w_c=w_c)
    assert fg.sweep_launches == before + 1
    want_labels, want_loads = fg.fennel_sweep_plain(*seen["args"], **seen["kw"])
    assert torch.equal(labels, want_labels)
    assert torch.equal(loads, want_loads)
    assert bool((labels[:n] >= 0).all())
    if k * cap < arrays[3].sum():
        assert float(loads.max()) > cap  # the fallback ran
    return seen, labels, loads


@pytest.mark.parametrize("cap_share", [1.05, 0.97])
@pytest.mark.parametrize("n,n_pad,k,n_free,hub,gamma", SWEEP_CASES)
def test_sweep_kernel_matches_plain_on_card(n, n_pad, k, n_free, hub, gamma, cap_share, card,
                                            monkeypatch):
    """`_initial_fennel` on the card (one sweep launch) against the sweep's
    plain version on the same prepared arguments, bit for bit."""
    _sweep_on_card_against_plain(n, n_pad, k, n_free, hub, gamma, cap_share, card, monkeypatch)


@pytest.mark.parametrize("cap_share", [1.05, 0.97])
@pytest.mark.parametrize("n,n_pad,k,n_free,hub,gamma", SWEEP_CASES)
def test_sweep_kernel_matches_plain_on_fractional_weights(n, n_pad, k, n_free, hub, gamma,
                                                          cap_share, card, monkeypatch):
    """The same on edge weights drawn from uniform(0.5, 2.0): the kernel
    sums a node's segment in segment order, the plain version as torch's
    reduction does; labels and loads must still agree bit for bit."""
    _sweep_on_card_against_plain(n, n_pad, k, n_free, hub, gamma, cap_share, card, monkeypatch,
                                 fractional=True)


@pytest.mark.parametrize("k", [1, 2, 31, 32])
@pytest.mark.parametrize("gamma", [1.5, 3.0])
@pytest.mark.parametrize("kind", KINDS)
def test_sweep_kernel_matches_plain_on_chained_levels(kind, gamma, k, card, monkeypatch):
    """Levels whose order steps from a node to its neighbour (a path, a
    mesh's rows), so the kernel's keys for "my block took the step
    before" decide most steps: integer weights, weights up to 2^40,
    integral and fractional segments alternating in one launch, segments
    past the short path's 8 entries, ties in every block, steps with no
    feasible block, one free node.  Bit for bit against the plain sweep."""
    level = chained_level(kind, k, seed=k, side=55)
    _, n, n_free, _, cap, _ = level
    _, labels, loads = _sweep_check(level, gamma, card, monkeypatch)
    if kind == "infeasible":
        assert float(loads.max()) > cap
    if kind == "single":
        assert n_free == 1
    if kind == "ties":  # unit weights over k blocks: the loads differ by at most one
        assert float(loads.max() - loads.min()) <= 1.0


@pytest.mark.parametrize("kind", ["mesh", "mixed", "long", "ties", "infeasible"])
def test_sweep_stamped_copy_matches_kernel_and_counts_paths(kind, card, monkeypatch):
    """The stamped copy (`_sweep_stamped`, chip_smoke's cycle counters)
    gives the kernel's labels and loads and counts every prepared step on
    one summation path at most; it launches nothing that is counted."""
    arrays, n, n_free, loads0, cap, w_c = chained_level(kind, 32, seed=5, side=55)
    a = [torch.from_numpy(x).to(card) for x in arrays]
    seen = {}

    def record(*x, **y):
        seen["args"], seen["kw"] = x, y

    monkeypatch.setattr(mlt, "fennel_sweep", record)
    mlt._initial_fennel(*a, n, n_free, torch.from_numpy(loads0).to(card), 0.3, 1.5, cap,
                        w_c=w_c)
    sa, skw = seen["args"], seen["kw"]
    kw = {key: skw[key] for key in ("alpha", "gamma", "cap")}
    before = fg.sweep_launches
    labels, loads, st = fg._sweep_stamped(*sa, **kw)
    assert fg.sweep_launches == before
    want_labels, want_loads = fg.fennel_sweep(*sa, **skw)
    assert torch.equal(labels, want_labels) and torch.equal(loads, want_loads)
    assert st["steps"] == n_free
    paths = st["long_steps"] + st["direct_steps"] + st["ordered_steps"] + st["exact_steps"]
    assert paths <= n_free
    assert st["main_cycles"] > 0 and st["chain_cycles"] > 0 and st["chain_reps"] > 0
    if kind == "long":
        assert st["long_steps"] == n_free
    if kind == "mixed":
        assert st["ordered_steps"] > 0 and st["exact_steps"] > 0
    if kind == "infeasible":
        assert st["fallback_steps"] > 0
    if kind == "ties":  # every block ties at the first step
        assert st["settle_steps"] > 0


def test_dlrm_forward_launches_one_bag_kernel_per_forward(card):
    cfg = dlrm_mlperf.smoke_config()
    params = dlrm.dlrm_init(torch.Generator(device=card).manual_seed(0), cfg)
    batch = {k: v.to(card) for k, v in dlrm_mlperf.smoke_batch(cfg).items()}
    cpu_params = {k: v.cpu() if torch.is_tensor(v) else {n: w.cpu() for n, w in v.items()}
                  for k, v in params.items()}
    before = eb.launches
    logits = dlrm.dlrm_forward(params, batch, cfg)
    assert eb.launches == before + 1
    want = dlrm.dlrm_forward(cpu_params, {k: v.cpu() for k, v in batch.items()}, cfg)
    torch.testing.assert_close(logits.cpu(), want, rtol=1e-5, atol=1e-5)
    res = serve_dlrm(cfg, batch, iters=3, device=card, params=params)
    assert eb.launches == before + 1 + res.forwards == before + 5
    query = {"query_dense": batch["dense"][:1], "query_sparse_idx": batch["sparse_idx"][:1],
             "query_sparse_mask": batch["sparse_mask"][:1],
             "candidates": torch.randn((100, cfg.embed_dim), device=card)}
    dlrm.dlrm_retrieval(params, query, cfg)
    assert eb.launches == before + 6


# ------------------------------------------------- the pipelined driver

def _pipe_cfg(engine):
    from repro_torch.core import BuffCutConfig

    return BuffCutConfig(k=8, buffer_size=2048, batch_size=512, d_max=64,
                         ml=MultilevelConfig(engine=engine,
                                             device="cuda" if engine == "torch" else "cpu"))


def test_pipelined_driver_on_card_matches_sparse(card):
    """T3 runs the device V-cycle off the calling thread: labels and cut
    equal the host `sparse` engine's, and every batch launched the sweep."""
    from repro_torch.core import PipelineConfig, buffcut_partition_pipelined

    g = rmat_graph(2**13, 8, seed=3)
    want, want_s = buffcut_partition_pipelined(g, _pipe_cfg("sparse"))
    before = fg.sweep_launches
    got, got_s = buffcut_partition_pipelined(g, _pipe_cfg("torch"),
                                             PipelineConfig(queue_depth=2, prefetch_batches=1))
    assert np.array_equal(got, want) and got_s.cut_weight == want_s.cut_weight
    assert fg.sweep_launches - before == got_s.n_batches > 1


def test_pipelined_worker_uses_the_callers_stream(card, monkeypatch):
    """Inside torch.cuda.stream(s), every V-cycle runs on a worker thread
    whose current stream is s; labels equal the sequential driver's."""
    import threading

    from repro_torch.core import PipelineConfig, buffcut_partition, buffcut_partition_pipelined

    seen = []
    vcycle = mlt.multilevel_partition_torch

    def recording(*a, **kw):
        seen.append((threading.get_ident(), torch.cuda.current_stream()))
        return vcycle(*a, **kw)

    monkeypatch.setattr(mlt, "multilevel_partition_torch", recording)
    g = rmat_graph(2**12, 8, seed=4)
    cfg = _pipe_cfg("torch")
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        got, _ = buffcut_partition_pipelined(g, cfg, PipelineConfig(prefetch_batches=2))
    assert seen and all(tid != threading.get_ident() and cur == s for tid, cur in seen)
    seen.clear()
    want, _ = buffcut_partition(g, cfg)
    assert np.array_equal(got, want)
    assert seen and all(cur == torch.cuda.default_stream() for _, cur in seen)


def test_pipelined_worker_error_reaches_the_caller(card, monkeypatch):
    """A fault in T3's device V-cycle fails the run on the calling thread
    and leaves no worker or pump thread."""
    import threading

    from repro_torch.core import PipelineConfig, buffcut_partition_pipelined

    def failing(*a, **kw):
        raise RuntimeError("device V-cycle failed")

    monkeypatch.setattr(mlt, "multilevel_partition_torch", failing)
    with pytest.raises(RuntimeError, match="device V-cycle failed"):
        buffcut_partition_pipelined(rmat_graph(2**12, 8, seed=5), _pipe_cfg("torch"),
                                    PipelineConfig(queue_depth=1, prefetch_batches=2))
    assert not [t for t in threading.enumerate()
                if t.name in ("buffcut-t3", "prefetch-pump") and t.is_alive()]


# --------------------------------------- out of core: disk, resume, restream

def _ooc_cfg(engine):
    from repro_torch.core import BuffCutConfig

    return BuffCutConfig(k=8, buffer_size=1024, batch_size=256, d_max=64,
                         ml=MultilevelConfig(engine=engine,
                                             device="cuda" if engine == "torch" else "cpu"))


@pytest.fixture
def rmat_file(tmp_path):
    from repro_torch.graphs import write_packed

    g = rmat_graph(4096, 8, seed=7)
    path = str(tmp_path / "rmat.bcsr")
    write_packed(g, path, section_records=256)
    return g, path


@pytest.mark.parametrize("driver", ["sequential", "pipelined", "vectorized"])
def test_disk_matches_memory_on_card(card, driver, rmat_file):
    """engine "torch" on the card: the disk stream's labels and cut equal
    the in-memory graph's, and every batch launched the sweep kernel."""
    from repro_torch.core import (
        PipelineConfig,
        VectorizedConfig,
        buffcut_partition,
        buffcut_partition_pipelined,
        buffcut_partition_vectorized,
        edge_cut,
    )
    from repro_torch.graphs import DiskNodeStream

    run = {"sequential": buffcut_partition,
           "pipelined": lambda s, c: buffcut_partition_pipelined(s, c, PipelineConfig()),
           "vectorized": lambda s, c: buffcut_partition_vectorized(
               s, c, VectorizedConfig(wave=8, chunk=8))}[driver]
    g, path = rmat_file
    cfg = _ooc_cfg("torch")
    want, want_s = run(g, cfg)
    before, hist_before = fg.sweep_launches, eh.launches
    got, got_s = run(DiskNodeStream(path), cfg)
    assert np.array_equal(got, want)
    assert got_s.cut_weight == want_s.cut_weight == edge_cut(g, got)
    assert fg.sweep_launches - before == got_s.n_batches > 1
    assert eh.launches > hist_before


@pytest.mark.parametrize("driver", ["sequential", "pipelined", "vectorized"])
def test_resume_on_card_is_bit_identical(card, driver, rmat_file, tmp_path, monkeypatch):
    import shutil

    import repro_torch.core.checkpoint as ckmod
    from repro_torch.core import (
        Checkpointer,
        PipelineConfig,
        VectorizedConfig,
        buffcut_partition,
        buffcut_partition_pipelined,
        buffcut_partition_vectorized,
        load_checkpoint,
    )
    from repro_torch.graphs import DiskNodeStream

    run = {"sequential": buffcut_partition,
           "pipelined": lambda s, c, **kw: buffcut_partition_pipelined(s, c, PipelineConfig(),
                                                                       **kw),
           "vectorized": lambda s, c, **kw: buffcut_partition_vectorized(
               s, c, VectorizedConfig(wave=8, chunk=8), **kw)}[driver]
    _, path = rmat_file
    cfg = _ooc_cfg("torch")
    want, want_s = run(DiskNodeStream(path), cfg)
    real, copies = ckmod.save_checkpoint, []

    def tee(p, state):
        real(p, state)
        copies.append(str(tmp_path / f"{len(copies)}.ckpt"))
        shutil.copy(p, copies[-1])

    monkeypatch.setattr(ckmod, "save_checkpoint", tee)
    got, got_s = run(DiskNodeStream(path), cfg, ckpt=Checkpointer(str(tmp_path / "c"), every=4))
    monkeypatch.undo()
    assert np.array_equal(got, want) and got_s.checkpoints_written == len(copies) > 0
    for snap in (copies[0], copies[-1]):
        res, res_s = run(DiskNodeStream(path), cfg, resume=load_checkpoint(snap))
        assert np.array_equal(res, want) and res_s.cut_weight == want_s.cut_weight


@pytest.mark.parametrize("order", ["stream", "priority"])
def test_restream_pass_on_card_keeps_an_exact_cut(card, order, rmat_file):
    from repro_torch.core import buffcut_partition, edge_cut, restream_refine
    from repro_torch.graphs import DiskNodeStream

    g, path = rmat_file
    cfg = _ooc_cfg("torch")
    b0, s0 = buffcut_partition(DiskNodeStream(path), cfg)
    before = fg.sweep_launches
    b1, info = restream_refine(DiskNodeStream(path), b0, cfg, 1, order=order,
                               initial_cut=s0.cut_weight,
                               initial_loads=np.asarray(s0.block_loads))
    assert info.cut_weight == edge_cut(g, b1)
    assert fg.sweep_launches - before == info.passes[0]["n_batches"] > 0
    want, winfo = restream_refine(g, b0, _ooc_cfg("sparse"), 1, order=order,
                                  initial_cut=s0.cut_weight,
                                  initial_loads=np.asarray(s0.block_loads))
    assert np.array_equal(b1, want) and info.cut_weight == winfo.cut_weight


# ------------------------------------------------------- the front door

@pytest.mark.parametrize("driver", ["buffcut", "heistream"])
def test_api_on_card_matches_host_sparse(driver, card, monkeypatch):
    """`repro_torch.api.partition` with the device V-cycle on R-MAT 2^16
    (k = 32, Q = 16384, delta = 8192) equals the host `sparse` engine's
    labels, and every V-cycle launched the sweep kernel once."""
    from repro_torch.api import partition

    g = rmat_graph(2**16, 8, seed=0)
    kw = dict(k=32, buffer_size=16384, batch_size=8192, driver=driver)
    engine = mlt.multilevel_partition_torch
    vcycles = []

    def counted(*a, **k_):
        vcycles.append(1)
        return engine(*a, **k_)

    monkeypatch.setattr(mlt, "multilevel_partition_torch", counted)
    before, hist_before = fg.sweep_launches, eh.launches
    got = partition(g, engine="torch", **kw)
    sweeps, hist = fg.sweep_launches - before, eh.launches - hist_before
    want = partition(g, engine="sparse", device="cpu", **kw)
    assert got.provenance["device"] == "cuda" and got.provenance["engine"] == "torch"
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.cut_weight == want.cut_weight
    assert sweeps == len(vcycles) == got.stats.n_batches > 1
    assert hist > 0


# ------------------------------------------------------------ the GNN path

def _tree_to(tree, device):
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.to(device) if torch.is_tensor(t) else t, tree)


def test_sage_sampled_loss_and_grads_on_card_match_cpu(card, monkeypatch):
    """graphsage-reddit at full width on a sampled batch of 64 seeds (25-10
    fanout): loss and every gradient on the card equal the CPU's at rtol
    1e-4 with TF32 off."""
    from repro_torch.configs import graphsage_reddit
    from repro_torch.models import gnn
    from repro_torch.train.loop import value_and_grad

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = graphsage_reddit.full_config()
    params = gnn.sage_init(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    b, (f1, f2) = 64, cfg.sample_sizes
    batch = {"feats": [torch.from_numpy(rng.standard_normal((n, cfg.d_in)).astype(np.float32))
                       for n in (b, b * f1, b * f1 * f2)],
             "labels": torch.from_numpy(rng.integers(0, cfg.n_classes, b).astype(np.int32))}
    loss_fn = lambda p, bt: gnn.sage_loss(p, bt, cfg)  # noqa: E731
    want_loss, want = value_and_grad(loss_fn, params, batch)
    got_loss, got = value_and_grad(loss_fn, _tree_to(params, card), _tree_to(batch, card))
    torch.testing.assert_close(got_loss.cpu(), want_loss, rtol=1e-4, atol=1e-6)
    from repro_torch.tree import tree_flatten_with_path

    want_flat = dict(tree_flatten_with_path(want))
    for path, g in tree_flatten_with_path(got):
        assert g.device.type == "cuda"
        torch.testing.assert_close(g.cpu(), want_flat[path], rtol=1e-4, atol=1e-6, msg=path)


@pytest.mark.parametrize("masked", [False, True])
def test_segment_mean_on_card_matches_cpu(masked, card):
    """index_add on the card sums with float atomics, in no fixed order:
    equal to the CPU's at rtol 1e-5."""
    from repro_torch.models import gnn

    rng = np.random.default_rng(1)
    data = torch.from_numpy(rng.standard_normal((200_000, 64)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 5000, 200_000).astype(np.int32))
    mask = torch.from_numpy((rng.random(200_000) > 0.2).astype(np.float32)) if masked else None
    want = gnn.segment_mean(data, ids, 6000, mask)
    got = gnn.segment_mean(data.to(card), ids.to(card), 6000,
                           None if mask is None else mask.to(card))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)
    with pytest.raises(IndexError):
        gnn.segment_mean(data.to(card), ids.to(card), 4000)


@pytest.mark.parametrize("arch", ["egnn", "meshgraphnet", "schnet", "graphsage-reddit"])
def test_gnn_full_preset_first_step_on_card_matches_cpu(arch, card, monkeypatch):
    """`build_training(arch, "full")`'s first train step on the card: its
    loss and gradient norm equal the CPU's at rtol 1e-4 (TF32 off)."""
    from repro_torch.launch.train import build_training
    from repro_torch.train import AdamW, make_train_step

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    out = {}
    for dev in ("cpu", "cuda"):
        cfg, params, loss, data = build_training(arch, "full", device=dev)
        opt = AdamW(lr=1e-3)
        _, _, m = make_train_step(loss, opt)(params, opt.init(params), next(data))
        out[dev] = (float(m["loss"]), float(m["grad_norm"]))
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-4)


def test_place_graph_on_card_matches_cpu_and_launches_the_histogram(card):
    """BuffCut placement through the default engine (`auto`: the host
    V-cycle with the histogram kernel on the card) gives the host `sparse`
    engine's labels."""
    from repro_torch.distributed.gnn_placement import place_graph
    from repro_torch.graphs import apply_order, random_order, rgg_graph

    g0 = rgg_graph(8192, seed=3)
    g = apply_order(g0, random_order(g0, 1))
    before = eh.launches
    got = place_graph(g, 8, method="buffcut")
    launched = eh.launches - before
    want = place_graph(g, 8, method="buffcut", device="cpu")
    np.testing.assert_array_equal(got.block, want.block)
    assert got.cut_edges == want.cut_edges and launched > 0


def test_embedding_bag_raises_on_a_card_table_that_requires_grad(card):
    """The kernel has no backward: a table that requires grad, with grad
    mode on, raises instead of losing its gradient; serving (no grad) and
    a table without grad launch as before."""
    table = torch.randn((100, 16), device=card, requires_grad=True)
    idx = torch.randint(0, 100, (8, 2), device=card, dtype=torch.int32)
    mask = torch.ones((8, 2), device=card)
    before = eb.launches
    with pytest.raises(RuntimeError, match="has no backward"):
        eb.embedding_bag(table, idx, mask)
    assert eb.launches == before
    with torch.no_grad():
        served = eb.embedding_bag(table, idx, mask)
    plain = eb.embedding_bag(table.detach(), idx, mask)
    assert eb.launches == before + 2
    assert torch.equal(served, plain)
    assert torch.equal(plain, eb.embedding_bag_plain(table.detach(), idx, mask))


# ------------------------------------------------- MoE and LM / DLRM training

def _moe_layer(tied: bool, dtype: torch.dtype, seed: int = 0):
    """A MoE layer with moonshot's routing (64 experts, top-6, 2 shared) at
    d = 512, f = 256; with `tied`, every odd expert's router column is a
    copy of the even one before it, so their probabilities tie."""
    import dataclasses

    from repro_torch.configs import moonshot_v1_16b_a3b
    from repro_torch.models import transformer as tfm

    cfg = dataclasses.replace(moonshot_v1_16b_a3b.full_config(), n_layers=1, d_model=512,
                              d_ff=256, vocab=64, dtype={torch.float32: "float32",
                                                         torch.bfloat16: "bfloat16"}[dtype])
    params = tfm.init_params(torch.Generator().manual_seed(seed), cfg)
    layer = tfm._layers(params)[0]
    if tied:
        layer["router"][:, 1::2] = layer["router"][:, 0::2]
    return cfg, layer


@pytest.mark.parametrize("tied", [False, True])
def test_moe_ffn_on_card_matches_cpu(tied, card, monkeypatch):
    """The dispatch's slots, token ids and keep mask on the card equal the
    CPU's exactly (ties broken to the lower expert on both), and the
    layer's output at rtol / atol 1e-4 in float32 with TF32 off."""
    from repro_torch.models import transformer as tfm

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg, layer = _moe_layer(tied, torch.float32)
    x3 = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 128, 512))
                          .astype(np.float32))
    card_layer = {k: v.to(card) for k, v in layer.items()}
    t, e, k = 512, cfg.n_experts, cfg.top_k
    cap = tfm._moe_cap(t, k, e, cfg.capacity_factor)
    want = tfm._moe_dispatch(x3.reshape(t, -1), layer["router"], e, k, cap)
    got = tfm._moe_dispatch(x3.reshape(t, -1).to(card), card_layer["router"], e, k, cap)
    for name, w, g in zip(("slot", "token", "weight", "keep"), want, got):
        if name == "weight":
            torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=1e-6)
        else:
            assert torch.equal(g.cpu(), w), name
    if tied:
        chosen = got[0][got[3].reshape(-1)] // cap
        odd = chosen[chosen % 2 == 1]
        assert bool(torch.isin(odd - 1, chosen).all())
    torch.testing.assert_close(tfm.moe_ffn(x3.to(card), card_layer, cfg).cpu(),
                               tfm.moe_ffn(x3, layer, cfg), rtol=1e-4, atol=1e-4)


def test_moe_ffn_rerun_on_card_is_bit_equal(card):
    """bf16 at prefill size (4096 tokens): two runs give the same bits (no
    float atomics in the combine; the pack's only repeated index is the
    trash row, which is cut off)."""
    from repro_torch.models import transformer as tfm

    cfg, layer = _moe_layer(False, torch.bfloat16)
    layer = {k: v.to(card) for k, v in layer.items()}
    x3 = torch.randn((4, 1024, 512), generator=torch.Generator().manual_seed(2)).to(
        card, torch.bfloat16)
    first = tfm.moe_ffn(x3, layer, cfg)
    assert torch.equal(first, tfm.moe_ffn(x3, layer, cfg))


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "moonshot-v1-16b-a3b", "stablelm-3b",
                                  "command-r-plus-104b", "h2o-danube-1.8b", "dlrm-mlperf"])
def test_lm_and_dlrm_smoke_first_step_on_card_matches_cpu(arch, card, monkeypatch):
    """`build_training(arch, "smoke")`'s first train step on the card: loss
    and gradient norm equal the CPU's at rtol 1e-4 (TF32 off); DLRM's loss
    launches no bag kernel (it pools through the plain bag)."""
    from repro_torch.launch.train import build_training
    from repro_torch.train import AdamW, make_train_step

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    out = {}
    for dev in ("cpu", "cuda"):
        _, params, loss, data = build_training(arch, "smoke", device=dev)
        opt = AdamW(lr=1e-3)
        before = eb.launches
        _, _, m = make_train_step(loss, opt)(params, opt.init(params), next(data))
        assert eb.launches == before
        out[dev] = (float(m["loss"]), float(m["grad_norm"]))
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-4)


# ---------------------------------------------------------- the device mesh

@pytest.fixture
def nccl_world(card):
    """A world of one on NCCL (FileStore), destroyed after the test."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_world_of_one, make_host_mesh

    init_world_of_one("cuda")
    try:
        yield make_host_mesh(1, 1, device="cuda")
    finally:
        dist.destroy_process_group()


def test_mesh_world_of_one_runs_nccl(nccl_world):
    import torch.distributed as dist

    assert dist.get_backend() == "nccl" and nccl_world.device_type == "cuda"


def test_expert_parallel_moe_at_one_rank_equals_one_device_on_card(nccl_world):
    """At (1, 1) the expert-parallel layer sees every token, so it is the
    one-device MoE, all-to-alls on NCCL included, bit for bit."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import MeshSharding, lm_sharding_rules
    from repro_torch.models import transformer as tfm
    from repro_torch.train.elastic import reshard_state

    mesh = nccl_world
    cfg = get_arch("moonshot-v1-16b-a3b").smoke_config()
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    keys = ("router", "moe_w1", "moe_w2", "moe_w3", "shared_w1", "shared_w2", "shared_w3")
    layer = {k: params[k][0].cuda() for k in keys}
    x3 = torch.randn((2, 16, cfg.d_model), generator=torch.Generator().manual_seed(1)).cuda()
    want = tfm.moe_ffn(x3, layer, cfg)
    placed = reshard_state({k: params[k].numpy() for k in keys}, lm_sharding_rules(True), mesh)
    spec = (("data",), "model", None)
    xd = distribute_tensor(x3, mesh, MeshSharding(mesh, spec).placements(), src_data_rank=None)
    tfm.set_moe_spmd(mesh, x_spec=spec)
    try:
        got = tfm.moe_ffn(xd, {k: v[0] for k, v in placed.items()}, cfg).full_tensor()
    finally:
        tfm.set_moe_spmd(None)
    assert torch.equal(got, want)


def test_dlrm_serve_cell_on_card_equals_dlrm_forward(nccl_world):
    """The serve_p99 cell at smoke size: the bag kernel on the tables'
    local shard, launched from the cell, and the logits of dlrm_forward."""
    from repro_torch.launch.steps import SMOKE_DIMS, build_cell, full_value, step_cell

    mesh = nccl_world
    cfg = dlrm_mlperf.smoke_config()
    cell = build_cell("dlrm-mlperf", "serve_p99", mesh, cfg_override=cfg,
                      dims_override=SMOKE_DIMS["recsys"])
    params = dlrm.dlrm_init(torch.Generator(device="cuda").manual_seed(0), cfg)
    batch = {k: v.cuda() for k, v in dlrm_mlperf.draw_batch(cfg, 32, seed=1).items()
             if k != "labels"}
    eb.launches = 0
    with torch.no_grad():
        got = full_value(step_cell(cell, mesh, (params, batch)))
    assert eb.launches > 0
    with torch.no_grad():
        assert torch.equal(got, dlrm.dlrm_forward(params, batch, cfg))


def test_halo_loss_on_card_matches_sage_loss(nccl_world):
    """The halo loss and its gradients at one rank on the card against
    sage_loss on the assembled graph: the loss at rtol 1e-5, each gradient
    leaf within 1e-5 of its norm (the segment sums are float atomics
    here)."""
    from repro_torch.distributed.gnn_placement import assemble_halo_batch, halo_batch
    from repro_torch.models import gnn
    from repro_torch.train.loop import value_and_grad
    from repro_torch.tree import tree_leaves, tree_map

    g = grid_mesh_graph(24)
    rng = np.random.default_rng(0)
    block = rng.integers(0, 4, g.n)
    hb = halo_batch(g, block, 1, rng.standard_normal((g.n, 6)).astype(np.float32),
                    rng.integers(0, 3, g.n).astype(np.int32))
    batch = {k: torch.from_numpy(v).cuda() for k, v in hb.items()
             if k not in ("node", "n_shards")}
    whole = {k: torch.from_numpy(v).cuda() for k, v in assemble_halo_batch(hb).items()}
    cfg = gnn.GraphSAGEConfig(n_layers=2, d_hidden=16, d_in=6, n_classes=3)
    params = tree_map(lambda t: t.cuda(), gnn.sage_init(torch.Generator().manual_seed(0), cfg))
    loss, grads = value_and_grad(
        lambda p, b: gnn.sage_fullgraph_halo_loss(p, b, cfg, nccl_world, ("data",)),
        params, batch)
    want, wgrads = value_and_grad(lambda p, b: gnn.sage_loss(p, b, cfg), params, whole)
    torch.testing.assert_close(loss, want, rtol=1e-5, atol=0)
    for a, b in zip(tree_leaves(grads), tree_leaves(wgrads)):   # 1e-5 of each leaf's norm
        assert float((a - b).norm() / b.norm()) <= 1e-5
