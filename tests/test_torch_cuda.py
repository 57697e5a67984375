"""repro_torch on a CUDA card: the ell_histogram and swa_attention kernels
against their plain versions, and the device engines against the port's
host `sparse` engine.

Every test is marked `cuda` and skips without a card.  The file imports
neither jax nor the JAX package, so it runs on a machine that has only
PyTorch:  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import repro_torch.core.multilevel_torch as mlt
from repro_torch.core.batch_model import build_batch_model
from repro_torch.core.fennel import FennelParams
from repro_torch.core.multilevel import MultilevelConfig, multilevel_partition
from repro_torch.graphs import grid_mesh_graph, rmat_graph
from repro_torch.kernels import ell_histogram as eh
from repro_torch.kernels import swa_attention as sw

pytestmark = pytest.mark.cuda

SHAPES = [(1, 1, 2), (7, 13, 4), (64, 32, 16), (130, 7, 32), (100, 64, 256),
          (64, 16, 1000), (65536, 8, 32), (4096, 64, 4096)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("b,w,k", SHAPES)
def test_kernel_matches_plain_on_card(b, w, k, card):
    rng = np.random.default_rng(b + w + k)
    blk = rng.integers(-1, k, (b, w)).astype(np.int32)
    for wts in (rng.integers(1, 6, (b, w)), rng.random((b, w))):
        wts = (wts * (blk >= 0)).astype(np.float32)
        blk_c, wts_c = torch.from_numpy(blk).to(card), torch.from_numpy(wts).to(card)
        before = eh.launches
        got = eh.block_histogram(blk_c, wts_c, k)
        assert eh.launches == before + 1
        # the plain version repeats the kernel's float32 adds in w order
        assert torch.equal(got, eh.ell_histogram_plain(blk_c, wts_c, k))


# (B, S, KVH, G, D, window, pos): ragged pos past the window, pos = 0, a
# window wider than the cache, D = 64 and 128, G = 1
SWA_SHAPES = [(4, 700, 8, 4, 80, 256, (600, 300, 256, 3)), (3, 64, 8, 4, 80, 4096, (0, 0, 0)),
              (2, 100, 2, 4, 80, 4096, (100, 60)), (2, 300, 4, 4, 64, 128, (300, 7)),
              (2, 300, 4, 4, 128, 128, (250, 129)), (2, 300, 8, 1, 80, 64, (300, 1))]


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


def test_swa_kernel_refuses_what_it_cannot_run(card):
    q, k, v, p = _swa_inputs(1, 8192, 1, 16, 128, (8192,), torch.float32, card)
    with pytest.raises(ValueError, match="shared memory"):  # 16 x 8192 float32 scores
        sw.swa_attention_decode(q, k, v, p, window=8192)
    q, k, v, p = _swa_inputs(1, 16, 1, 17, 64, (8,), torch.float32, card)
    with pytest.raises(ValueError, match="query heads"):
        sw.swa_attention_decode(q, k, v, p, window=8)
    q, k, v, p = _swa_inputs(1, 16, 1, 2, 60, (8,), torch.bfloat16, card)
    with pytest.raises(ValueError, match="16-byte"):
        sw.swa_attention_decode(q, k, v, p, window=8)


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
    got = multilevel_partition(model.graph, model.pinned_block, p, loads,
                               MultilevelConfig(engine=engine, device=str(card)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("gamma", [1.25, 2.5])
def test_device_engine_matches_host_at_other_gammas(gamma, card):
    """gamma outside {1.5, 2, 3}: the device penalty takes CUDA's pow and
    the host numpy's (libm); the labels are still the same."""
    import dataclasses

    model, p, loads = _batch_model(rmat_graph(512, 8, seed=3))
    p = dataclasses.replace(p, gamma=gamma)
    want = multilevel_partition(model.graph, model.pinned_block, p, loads,
                                MultilevelConfig(engine="sparse", device="cpu"))
    got = multilevel_partition(model.graph, model.pinned_block, p, loads,
                               MultilevelConfig(engine="torch", device=str(card)))
    np.testing.assert_array_equal(got, want)
