"""repro_torch's DLRM serving path against the JAX package on the CPU.

The smoke DLRM's forward, loss and retrieval go through both packages with
the reference's weights carried across by `dlrm_params_from_numpy`, on both
JAX bag routes (the Pallas kernel in interpret mode and the jnp oracle);
the config, shapes, input specs and smoke batch match the reference's; the
MLP pieces and the dot interaction match on their own; and `serve_dlrm`
and the serve CLI run on the CPU and raise without a card by default.
"""
import dataclasses
import functools
import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.dlrm_mlperf as ref_dlrm_cfg
import repro.kernels.ops as ref_ops
import repro.models.common as ref_common
import repro.models.dlrm as ref_dlrm
import repro_torch.configs.dlrm_mlperf as dlrm_cfg
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeDef
from repro_torch.convert import dlrm_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import common, dlrm

eb = importlib.import_module("repro_torch.kernels.embedding_bag")
T = torch.from_numpy
J = jnp.asarray
TOL = dict(rtol=1e-5, atol=1e-5)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _smoke(seed=0):
    cfg = dlrm_cfg.smoke_config()
    ref_params = ref_dlrm.dlrm_init(jax.random.PRNGKey(seed), ref_dlrm_cfg.smoke_config())
    return cfg, ref_params, dlrm_params_from_numpy(_numpy_tree(ref_params), device="cpu")


def _retrieval_batch(cfg, n_cand=256, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "query_dense": rng.standard_normal((1, cfg.n_dense)).astype(np.float32),
        "query_sparse_idx": rng.integers(
            0, cfg.vocab_size, (1, cfg.n_sparse, cfg.multi_hot)).astype(np.int32),
        "query_sparse_mask": np.ones((1, cfg.n_sparse, cfg.multi_hot), np.float32),
        "candidates": rng.standard_normal((n_cand, cfg.embed_dim)).astype(np.float32),
    }


@pytest.fixture
def bag_route(request):
    """The reference's forward with its bags on one JAX route (the Pallas
    kernel runs in interpret mode off a TPU)."""
    assert ref_ops.USE_KERNELS_DEFAULT is False
    return functools.partial(ref_dlrm.dlrm_forward, use_kernel=request.param == "pallas")


def test_configs_match_reference():
    for name in ("full_config", "smoke_config"):
        port_cfg = getattr(dlrm_cfg, name)()
        ref_cfg = getattr(ref_dlrm_cfg, name)()
        assert dataclasses.asdict(port_cfg) == dataclasses.asdict(ref_cfg), name
        assert port_cfg.n_interact == ref_cfg.n_interact
        assert port_cfg.param_count() == ref_cfg.param_count()
    full = dlrm_cfg.full_config()
    assert full.n_sparse * full.vocab_size * full.embed_dim * 4 == 13_958_643_712
    spec = get_arch("dlrm-mlperf")
    assert spec.family == "recsys" and spec.full_config == dlrm_cfg.full_config
    assert spec.shapes == {k: ShapeDef(**dataclasses.asdict(v))
                           for k, v in ref_dlrm_cfg.SHAPES.items()}
    dtypes = {jnp.float32: torch.float32, jnp.int32: torch.int32}
    for name, shape in spec.shapes.items():
        want = ref_dlrm_cfg.input_specs(ref_dlrm_cfg.full_config(), ref_dlrm_cfg.SHAPES[name])
        got = spec.input_specs(full, shape)
        assert list(got) == list(want), name
        for key, (shp, dt) in got.items():
            assert tuple(want[key].shape) == shp and dtypes[want[key].dtype.type] == dt, key


def test_smoke_batch_matches_reference():
    cfg = dlrm_cfg.smoke_config()
    for seed in (0, 3):
        got = dlrm_cfg.smoke_batch(cfg, seed)
        want = ref_dlrm_cfg.smoke_batch(ref_dlrm_cfg.smoke_config(), seed)
        assert list(got) == list(want)
        for key, arr in want.items():
            assert got[key].dtype == {np.float32: torch.float32,
                                      np.int32: torch.int32}[np.asarray(arr).dtype.type]
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(arr), err_msg=key)
    assert dlrm_cfg.draw_batch(cfg, 40, 1)["sparse_idx"].shape == (40, 4, 2)


def test_init_params_shapes_match_reference():
    cfg, ref_params, params = _smoke()
    mine = dlrm.dlrm_init(torch.Generator().manual_seed(0), cfg)
    shapes = jax.tree.map(lambda a: tuple(a.shape), _numpy_tree(ref_params))
    assert jax.tree.map(lambda t: tuple(t.shape), mine) == shapes
    assert jax.tree.map(lambda t: tuple(t.shape), params) == shapes
    for tree in (mine, params):
        assert all(t.dtype == torch.float32 for t in jax.tree.leaves(tree))
    n = sum(t.numel() for t in jax.tree.leaves(mine))
    biases = sum(t.numel() for part in ("bot", "top") for key, t in mine[part].items()
                 if key.startswith("b"))
    assert n - biases == cfg.param_count()  # param_count counts weights, as the reference's
    scale = 1 / np.sqrt(cfg.n_dense)
    assert float(mine["bot"]["w0"].abs().max()) <= scale and not mine["bot"]["b0"].any()


def test_mlp_pieces_match_reference():
    rng = np.random.default_rng(1)
    ref_mlp = _numpy_tree(ref_common.mlp_init(jax.random.PRNGKey(3), [13, 32, 16, 1]))
    mlp = {k: T(np.array(v)) for k, v in ref_mlp.items()}
    x = rng.standard_normal((9, 13)).astype(np.float32)
    for final in (None, "relu"):
        want = ref_common.mlp_apply(ref_mlp, J(x), act=jax.nn.relu,
                                    final_act=jax.nn.relu if final else None)
        got = common.mlp_apply(mlp, T(x), act=torch.relu,
                               final_act=torch.relu if final else None)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    w = common.dense_init(torch.Generator().manual_seed(0), 64, 8)
    assert w.shape == (64, 8) and float(w.abs().max()) <= 1 / 8
    params = common.mlp_init(torch.Generator().manual_seed(0), [5, 7, 3])
    assert sorted(params) == ["b0", "b1", "w0", "w1"] and params["w1"].shape == (7, 3)


def test_interaction_keeps_the_references_pair_order():
    rng = np.random.default_rng(2)
    dense_v = rng.standard_normal((3, 8)).astype(np.float32)
    sparse_v = rng.standard_normal((3, 5, 8)).astype(np.float32)
    want = ref_dlrm._interact(J(dense_v), J(sparse_v))
    got = dlrm._interact(T(dense_v), T(sparse_v))
    assert got.shape == (3, 15)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("bag_route", ["pallas", "jnp"], indirect=True)
def test_forward_matches_reference(bag_route):
    cfg, ref_params, params = _smoke()
    ref_cfg = ref_dlrm_cfg.smoke_config()
    for seed in (0, 1):
        batch = dlrm_cfg.smoke_batch(cfg, seed)
        # out-of-range indices clamp on both sides
        batch["sparse_idx"][0, 0, 0], batch["sparse_idx"][1, 2, 1] = -1, cfg.vocab_size
        ref_batch = {k: J(v.numpy()) for k, v in batch.items()}
        before = eb.launches
        got = dlrm.dlrm_forward(params, batch, cfg)
        assert eb.launches == before
        want = bag_route(ref_params, ref_batch, ref_cfg)
        assert got.shape == (16,) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_loss_matches_reference():
    cfg, ref_params, params = _smoke(seed=4)
    batch = dlrm_cfg.smoke_batch(cfg, 2)
    want = ref_dlrm.dlrm_loss(ref_params, {k: J(v.numpy()) for k, v in batch.items()},
                              ref_dlrm_cfg.smoke_config())
    got = dlrm.dlrm_loss(params, batch, cfg)
    assert got.shape == ()
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_retrieval_matches_reference():
    cfg, ref_params, params = _smoke(seed=1)
    batch = _retrieval_batch(cfg)
    want = ref_dlrm.dlrm_retrieval(ref_params, {k: J(v) for k, v in batch.items()},
                                   ref_dlrm_cfg.smoke_config())
    got = dlrm.dlrm_retrieval(params, {k: T(v) for k, v in batch.items()}, cfg)
    assert got.shape == (256,) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_pools_through_one_stacked_bag_call(monkeypatch):
    cfg, _, params = _smoke()
    calls = []

    def recording(table, idx, mask):
        calls.append((tuple(table.shape), tuple(idx.shape)))
        return eb.embedding_bag(table, idx, mask)

    monkeypatch.setattr(dlrm, "embedding_bag", recording)
    dlrm.dlrm_forward(params, dlrm_cfg.smoke_batch(cfg), cfg)
    dlrm.dlrm_retrieval(params, {k: T(v) for k, v in _retrieval_batch(cfg).items()}, cfg)
    assert calls == [((4, 128, 16), (16, 4, 2)), ((4, 128, 16), (1, 4, 2))]


# ---------------------------------------------------------------- serving

def test_serve_dlrm_on_cpu_matches_reference_forward():
    cfg, ref_params, params = _smoke()
    batch = dlrm_cfg.smoke_batch(cfg, 0)
    want = ref_dlrm.dlrm_forward(ref_params, {k: J(v.numpy()) for k, v in batch.items()},
                                 ref_dlrm_cfg.smoke_config())
    res = serve.serve_dlrm(cfg, batch, iters=3, device="cpu", params=params)
    assert res.device == "cpu" and res.forwards == 4
    np.testing.assert_allclose(res.scores.numpy(), np.asarray(want), **TOL)
    assert res.batch_s > 0 and res.us_per_batch == res.batch_s * 1e6
    assert res.samples_per_s == pytest.approx(16 / res.batch_s)
    own = serve.serve_dlrm(cfg, batch, iters=1, device="cpu")  # its own seeded weights
    assert own.scores.shape == (16,) and bool(torch.isfinite(own.scores).all())
    with pytest.raises(ValueError):
        serve.serve_dlrm(cfg, batch, iters=0, device="cpu", params=params)


def test_serve_dlrm_defaults_to_the_card():
    assert inspect.signature(serve.serve_dlrm).parameters["device"].default == "cuda"
    assert inspect.signature(dlrm_params_from_numpy).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works here")
    cfg = dlrm_cfg.smoke_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve_dlrm(cfg, dlrm_cfg.smoke_batch(cfg))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "dlrm-mlperf"])


def test_dlrm_serve_cli(capsys):
    serve.main(["--arch", "dlrm-mlperf", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("dlrm serve: device=cpu batch=16 ") and "us/batch" in out
    serve.main(["--arch", "dlrm-mlperf", "--device", "cpu", "--batch", "40"])
    assert "batch=40 " in capsys.readouterr().out
