"""repro_torch's training substrate against the JAX package on the CPU.

AdamW's update (clip and warmup both exercised), the train step at one and
two microbatches and with top-k compression, the compression ops, the data
pipelines, the checkpoints (both ways between the packages), the
fault-tolerant loop and the GNN trainer's entry point; and the DLRM loss's
gradient through the plain bag, which on the CPU equals the reference's.
Tolerances: the optimizer alone at rtol 1e-6; a train step, whose
gradients are summed in other orders, at rtol 1e-5 / atol 1e-6; the DLRM
gradients at rtol 1e-4 / atol 1e-5.  The compression tests draw continuous
values, so no two magnitudes tie (`jax.lax.top_k` and `torch.topk` may
order ties differently).
"""
import importlib
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.configs as ref_configs
import repro.configs.dlrm_mlperf as ref_dlrm_cfg
import repro.distributed.compression as ref_comp
import repro.models.dlrm as ref_dlrm
import repro.models.gnn as ref_gnn
import repro.train.data as ref_data
from repro.train.adamw import AdamW as RefAdamW
from repro.train.checkpoint import CheckpointManager as RefCheckpointManager
from repro.train.loop import make_train_step as ref_make_train_step
from repro_torch import configs
from repro_torch.configs import dlrm_mlperf
from repro_torch.convert import adamw_state_from_numpy, dlrm_params_from_numpy, \
    gnn_params_from_numpy
from repro_torch.distributed import compression as comp
from repro_torch.launch import train as train_cli
from repro_torch.models import dlrm, gnn
from repro_torch.train import (
    AdamW,
    AdamWState,
    CheckpointManager,
    LoopConfig,
    TrainLoop,
    dlrm_batches,
    gnn_batches,
    make_train_step,
    token_batches,
)
from repro_torch.train.loop import value_and_grad
from repro_torch.tree import tree_flatten_with_path, tree_map

ROOT = Path(__file__).resolve().parents[1]
GNN_ARCHS = ["egnn", "meshgraphnet", "schnet", "graphsage-reddit"]
STEP_TOL = dict(rtol=1e-5, atol=1e-6)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree) -> dict:
    return {p: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for p, v in tree_flatten_with_path(tree)}


def _assert_close(port_tree, ref_tree, **tol):
    got, want = _flat(port_tree), _flat(_numpy_tree(ref_tree))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, err_msg=path, **tol)


def _params_tree(seed: int) -> dict:
    """Multiples of 1/4 in [-4, 4]: their squares and the sums of those are
    exact in float32, so the global norm (summed in each package's own
    order) and the clip's scale are the same float in both packages, and
    what is left to compare is the update's arithmetic."""
    rng = np.random.default_rng(seed)

    def draw(shape):
        return (rng.integers(-16, 17, shape) / 4).astype(np.float32)

    return {"embed": {"w0": draw((5, 3)), "b0": draw(3)}, "head": draw(4)}


# ------------------------------------------------------------------ AdamW

@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_adamw_update_matches_reference(clip):
    """Six updates from the same grads, state and params, through the
    warmup (4 steps) and past it; with clip 1.0 every update clips."""
    kw = dict(lr=1e-2, warmup_steps=4, grad_clip=clip, weight_decay=0.1)
    ref_opt, opt = RefAdamW(**kw), AdamW(**kw)
    ref_params = jax.tree.map(jnp.asarray, _params_tree(0))
    params = tree_map(torch.from_numpy, _params_tree(0))
    ref_state, state = ref_opt.init(ref_params), opt.init(params)
    for it in range(6):
        g = _params_tree(10 + it)
        ref_params, ref_state, ref_gnorm = ref_opt.update(
            jax.tree.map(jnp.asarray, g), ref_state, ref_params)
        params, state, gnorm = opt.update(tree_map(torch.from_numpy, g), state, params)
        assert (float(gnorm) > clip) == (clip == 1.0)
        np.testing.assert_allclose(float(gnorm), float(ref_gnorm), rtol=1e-6)
        _assert_close(params, ref_params, rtol=1e-6)
        _assert_close(state.m, ref_state.m, rtol=1e-6)
        _assert_close(state.v, ref_state.v, rtol=1e-6)
        assert state.count.dtype == torch.int32 and int(state.count) == int(ref_state.count)
        assert all(t.dtype == torch.float32 for t in (*_flat_t(state.m), *_flat_t(state.v)))


def _flat_t(tree) -> list:
    return [v for _, v in tree_flatten_with_path(tree)]


def test_adamw_schedule_counts_before_it_reads():
    opt = AdamW(lr=1.0, warmup_steps=4)
    assert [float(opt.schedule(torch.tensor(c, dtype=torch.int32))) for c in (1, 2, 4, 9)] == [
        0.25, 0.5, 1.0, 1.0]


def test_adamw_reduces_quadratic():
    opt = AdamW(lr=0.1, weight_decay=0.0, warmup_steps=1)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(120):
        params, state, _ = opt.update({"w": 2 * params["w"]}, state, params)
    assert float(params["w"].abs().max()) < 0.15


def test_adamw_grad_clip():
    opt = AdamW(lr=0.1, grad_clip=1.0, warmup_steps=1)
    params = {"w": torch.zeros(3)}
    _, _, gnorm = opt.update({"w": torch.tensor([100.0, 0, 0])}, opt.init(params), params)
    assert float(gnorm) == pytest.approx(100.0)


# ------------------------------------------------------------- train step

def _sage_case(seed: int = 0, b: int = 8):
    """Smoke GraphSAGE with the reference's weights and a sampled batch whose
    leaves split cleanly in halves (the sampler's layers are parent-major)."""
    ref_cfg = ref_configs.get_arch("graphsage-reddit").smoke_config()
    cfg = configs.get_arch("graphsage-reddit").smoke_config()
    ref_params = ref_gnn.sage_init(jax.random.PRNGKey(seed), ref_cfg)
    rng = np.random.default_rng(seed + 1)
    f1, f2 = cfg.sample_sizes
    feats = [rng.standard_normal((n, cfg.d_in)).astype(np.float32) for n in (b, b * f1,
                                                                           b * f1 * f2)]
    labels = rng.integers(0, cfg.n_classes, b).astype(np.int32)
    ref_batch = {"feats": [jnp.asarray(f) for f in feats], "labels": jnp.asarray(labels)}
    batch = {"feats": [torch.from_numpy(f) for f in feats], "labels": torch.from_numpy(labels)}
    params = gnn_params_from_numpy(_numpy_tree(ref_params), device="cpu")
    return (lambda p, bt: ref_gnn.sage_loss(p, bt, ref_cfg), ref_params, ref_batch,
            lambda p, bt: gnn.sage_loss(p, bt, cfg), params, batch)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    ref_loss, ref_params, ref_batch, loss, params, batch = _sage_case()
    kw = dict(lr=1e-2, warmup_steps=2)
    ref_opt, opt = RefAdamW(**kw), AdamW(**kw)
    ref_step = jax.jit(ref_make_train_step(ref_loss, ref_opt, microbatches=microbatches))
    step = make_train_step(loss, opt, microbatches=microbatches)
    ref_state, state = ref_opt.init(ref_params), opt.init(params)
    for _ in range(2):
        ref_params, ref_state, ref_m = ref_step(ref_params, ref_state, ref_batch)
        params, state, m = step(params, state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]), **STEP_TOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(ref_m["grad_norm"]), **STEP_TOL)
        _assert_close(params, ref_params, **STEP_TOL)
        _assert_close(state.m, ref_state.m, **STEP_TOL)
    assert int(state.count) == 2


def test_compressed_train_step_matches_reference():
    ref_loss, ref_params, ref_batch, loss, params, batch = _sage_case(seed=2)
    kw = dict(lr=1e-2, warmup_steps=2)
    ref_opt, opt = RefAdamW(**kw), AdamW(**kw)
    ref_step = jax.jit(ref_make_train_step(ref_loss, ref_opt, compress_ratio=0.25))
    step = make_train_step(loss, opt, compress_ratio=0.25)
    ref_state, state = ref_opt.init(ref_params), opt.init(params)
    ref_res, res = ref_comp.init_residuals(ref_params), comp.init_residuals(params)
    for _ in range(2):
        ref_params, ref_state, ref_res, ref_m = ref_step(ref_params, ref_state, ref_batch,
                                                         ref_res)
        params, state, res, m = step(params, state, batch, res)
        np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]), **STEP_TOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(ref_m["grad_norm"]), **STEP_TOL)
        _assert_close(params, ref_params, **STEP_TOL)
        _assert_close(res, ref_res, **STEP_TOL)


def test_value_and_grad_gives_unreached_params_a_zero_gradient():
    params = {"used": torch.ones(3), "unused": torch.ones(2)}
    loss, grads = value_and_grad(lambda p, b: (p["used"] * b).sum(), params, torch.arange(3.0))
    assert float(loss) == 3.0 and not loss.requires_grad
    assert torch.equal(grads["used"], torch.arange(3.0))
    assert torch.equal(grads["unused"], torch.zeros(2))


# ------------------------------------------------------------ compression

@pytest.mark.parametrize("ratio", [0.01, 0.1, 0.5, 1.0])
def test_compression_ops_match_reference(ratio):
    rng = np.random.default_rng(int(ratio * 100))
    g = rng.standard_normal((13, 7)).astype(np.float32)
    r = rng.standard_normal((13, 7)).astype(np.float32) * 0.1
    want_v, want_i = ref_comp.topk_compress(jnp.asarray(g), ratio)
    got_v, got_i = comp.topk_compress(torch.from_numpy(g), ratio)
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(comp.topk_decompress(got_v, got_i, g.shape).numpy(),
                                  np.asarray(ref_comp.topk_decompress(want_v, want_i, g.shape)))
    sent, res = comp.error_feedback_update(torch.from_numpy(g), torch.from_numpy(r), ratio)
    want_s, want_r = ref_comp.error_feedback_update(jnp.asarray(g), jnp.asarray(r), ratio)
    np.testing.assert_array_equal(sent.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(res.numpy(), np.asarray(want_r))
    q, scale = comp.quantize_int8(torch.from_numpy(g))
    want_q, want_scale = ref_comp.quantize_int8(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    np.testing.assert_allclose(float(scale), float(want_scale), rtol=1e-7)
    np.testing.assert_allclose(comp.dequantize_int8(q, scale).numpy(),
                               np.asarray(ref_comp.dequantize_int8(want_q, want_scale)),
                               rtol=1e-6)


@given(st.integers(1, 200), st.floats(0.01, 1.0), st.integers(0, 2**31 - 1))
@settings(max_examples=25, deadline=None)
def test_topk_roundtrip_property(n, ratio, seed):
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal(n).astype(np.float32))
    vals, idx = comp.topk_compress(g, ratio)
    dense = comp.topk_decompress(vals, idx, g.shape).numpy()
    kept = np.zeros(n, bool)
    kept[idx.numpy()] = True
    np.testing.assert_allclose(dense[kept], g.numpy()[kept], rtol=1e-6)
    assert (dense[~kept] == 0).all()
    if kept.sum() < n:
        assert np.abs(g.numpy()[kept]).min() >= np.abs(g.numpy()[~kept]).max() - 1e-6


def test_error_feedback_conserves_mass():
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(64).astype(np.float32))
    res, total = torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(30):
        sent, res = comp.error_feedback_update(g, res, ratio=0.1)
        total = total + sent
    np.testing.assert_allclose((total / 30).numpy(), g.numpy(), atol=0.25)


@given(st.integers(1, 64), st.integers(0, 2**31 - 1))
@settings(max_examples=20, deadline=None)
def test_int8_quant_bounded_error(n, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal(n) * rng.uniform(0.1, 10)).astype(np.float32))
    q, scale = comp.quantize_int8(x)
    assert float((comp.dequantize_int8(q, scale) - x).abs().max()) <= float(scale) * 0.5 + 1e-6


# ------------------------------------------------------------------- data

@pytest.mark.parametrize("shard,n_shards", [(0, 1), (1, 2)])
def test_token_batches_match_reference(shard, n_shards):
    kw = dict(seed=5, steps=3, shard=shard, n_shards=n_shards)
    want = list(ref_data.token_batches(100, 4, 8, **kw))
    got = list(token_batches(100, 4, 8, device="cpu", **kw))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        for key in ("tokens", "labels"):
            assert a[key].dtype == torch.int32
            np.testing.assert_array_equal(a[key].numpy(), np.asarray(b[key]))


def test_dlrm_batches_match_reference():
    want = list(ref_data.dlrm_batches(ref_dlrm_cfg.smoke_config(), 6, seed=2, steps=2))
    got = list(dlrm_batches(dlrm_mlperf.smoke_config(), 6, seed=2, steps=2, device="cpu"))
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for key in b:
            assert str(a[key].dtype).removeprefix("torch.") == str(b[key].dtype)
            np.testing.assert_array_equal(a[key].numpy(), np.asarray(b[key]))


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_gnn_batches_are_the_smoke_batches(arch):
    spec = configs.get_arch(arch)
    cfg = spec.smoke_config()
    got = list(gnn_batches(lambda s: spec.smoke_batch(cfg, s), seed=3, steps=2, device="cpu"))
    ref_spec = ref_configs.get_arch(arch)
    for step, batch in enumerate(got):
        want = ref_spec.smoke_batch(ref_spec.smoke_config(), 3 + step)
        for key, w in want.items():
            if isinstance(w, int):
                assert batch[key] == w
            else:
                np.testing.assert_array_equal(batch[key].numpy(), np.asarray(w))


# ------------------------------------------------------------- checkpoint

def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    state = {"a": torch.arange(5.0, dtype=torch.float64),
             "b": {"c": torch.ones((2, 3)), "n": torch.tensor(7, dtype=torch.int32)}}
    mgr.save(10, {"state": state, "step": 10})
    out = mgr.restore(10, template=state)
    assert out["step"] == 10
    for path, leaf in tree_flatten_with_path(out["state"]):
        want = dict(tree_flatten_with_path(state))[path]
        assert leaf.dtype == want.dtype and leaf.device == want.device
        assert torch.equal(leaf, want)


def test_checkpoint_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"state": {"a": torch.full((1,), float(s))}, "step": s})
    assert mgr.all_steps() == [3, 4]
    out = mgr.restore_latest(template={"a": torch.zeros(1)})
    assert out["step"] == 4 and float(out["state"]["a"][0]) == 4.0


def test_checkpoint_corruption_detected(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=3)
    state = {"a": torch.arange(10.0)}
    mgr.save(1, {"state": state, "step": 1})
    mgr.save(2, {"state": state, "step": 2})
    with open(os.path.join(str(tmp_path), "ckpt_00000002.npz"), "r+b") as f:
        f.seek(10)
        f.write(b"\x00" * 20)
    out = mgr.restore_latest(template=state)
    assert out is not None and out["step"] == 1  # falls back past corruption
    assert mgr.restore(2, template=state) is None
    assert mgr.restore(9) is None


def _gnn_state(seed: int = 0):
    """(ref (params, AdamWState), port (params, AdamWState)) after one
    update, equal leaf for leaf."""
    ref_cfg = ref_configs.get_arch("egnn").smoke_config()
    ref_params = jax.jit(lambda k: ref_gnn.egnn_init(k, ref_cfg))(jax.random.PRNGKey(seed))
    ref_opt = RefAdamW(lr=1e-2)
    g = jax.tree.map(lambda p: jnp.ones_like(p) * 0.5, ref_params)
    ref_params, ref_state, _ = jax.jit(ref_opt.update)(g, ref_opt.init(ref_params), ref_params)
    port = (gnn_params_from_numpy(_numpy_tree(ref_params), device="cpu"),
            adamw_state_from_numpy(_numpy_tree(ref_state), device="cpu"))
    return (ref_params, ref_state), port


def test_checkpoints_cross_between_the_packages(tmp_path):
    ref_state, state = _gnn_state()
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    CheckpointManager(str(tmp_path / "port")).save(3, {"state": state, "step": 3})
    RefCheckpointManager(str(tmp_path / "ref")).save(3, {"state": ref_state, "step": 3})
    with np.load(tmp_path / "port" / "ckpt_00000003.npz") as a, \
            np.load(tmp_path / "ref" / "ckpt_00000003.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert {"0/embed/w0", "1/.count", "1/.m/embed/w0", "1/.v/embed/w0"} <= set(a.files)
        for key in b.files:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    # the reference's file into the port's state, the port's into the reference's
    zeros = tree_map(torch.zeros_like, state)
    got = CheckpointManager(str(tmp_path / "ref")).restore_latest(template=zeros)
    assert got["step"] == 3 and isinstance(got["state"][1], AdamWState)
    _assert_close(got["state"], ref_state, rtol=0, atol=0)
    back = RefCheckpointManager(str(tmp_path / "port")).restore_latest(
        template=jax.tree.map(jnp.zeros_like, ref_state))
    assert back["step"] == 3
    _assert_close(state, back["state"], rtol=0, atol=0)


# ------------------------------------------------------------------- loop

def test_fault_recovery_loop(tmp_path):
    """tests/test_train_substrate.py's recovery check on a GNN smoke arch:
    two injected failures at step 6, restored from step 5's checkpoint."""
    spec = configs.get_arch("graphsage-reddit")
    cfg, params, loss, data = train_cli.build_training("graphsage-reddit", "smoke",
                                                       device="cpu")
    opt = AdamW(lr=1e-3)
    fails = {"n": 0}

    def hook(s):
        if s == 6 and fails["n"] < 2:
            fails["n"] += 1
            raise RuntimeError("injected node failure")

    loop = TrainLoop(make_train_step(loss, opt), CheckpointManager(str(tmp_path)),
                     LoopConfig(total_steps=10, checkpoint_every=5, max_retries=3),
                     fault_hook=hook)
    state, hist = loop.run(params, opt.init(params),
                           gnn_batches(lambda s: spec.smoke_batch(cfg, s), steps=30,
                                       device="cpu"))
    assert loop.retries == 2
    assert len(hist) >= 10 and np.isfinite(hist[-1])
    assert int(state[1].count) == 10


def test_loop_gives_up_after_max_retries(tmp_path):
    def step(p, o, b):
        raise RuntimeError("always down")

    loop = TrainLoop(step, CheckpointManager(str(tmp_path)), LoopConfig(max_retries=2))
    with pytest.raises(RuntimeError, match="always down"):
        loop.run({"w": torch.zeros(1)}, None, iter([{}] * 10))
    assert loop.retries == 3


# ----------------------------------------------------------------- launch

@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_train_cli_smoke_gives_a_finite_loss(arch, tmp_path, capsys):
    train_cli.main(["--arch", arch, "--preset", "smoke", "--steps", "5", "--device", "cpu",
                    "--ckpt-dir", str(tmp_path)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"arch={arch} device=cpu steps=5 loss ")
    first, last = (float(x) for x in line.split(" loss ")[1].split(" (")[0].split(" -> "))
    assert math.isfinite(first) and math.isfinite(last)


def test_python_m_train_runs_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "graphsage-reddit",
         "--preset", "smoke", "--steps", "5", "--device", "cpu", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("arch=graphsage-reddit device=cpu steps=5 loss ")


def test_build_training_starts_the_card_and_the_cpu_from_the_same_weights(monkeypatch):
    a = train_cli.build_training("egnn", "full", device="cpu")[1]
    b = train_cli.build_training("egnn", "full", device="cpu")[1]
    assert all(torch.equal(x, y) for x, y in zip(_flat_t(a), _flat_t(b)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.build_training("egnn", "smoke")


@pytest.mark.parametrize("flag", ["--batch", "--seq"])
def test_train_cli_has_no_batch_or_seq_flag(flag, capsys):
    """No GNN arch reads a batch or sequence size (they size LM and DLRM
    batches), so for a GNN the CLI, and `build_training`, refuse them
    instead of ignoring them."""
    with pytest.raises(SystemExit):
        train_cli.main(["--arch", "graphsage-reddit", "--device", "cpu", flag, "64"])
    assert f"error: {flag} sizes LM and DLRM batches; graphsage-reddit is a GNN" in \
        capsys.readouterr().err
    with pytest.raises(ValueError, match="is a GNN"):
        train_cli.build_training("graphsage-reddit", "smoke", **{flag[2:]: 64}, device="cpu")


# ------------------------------------------------------------ DLRM's bag

def test_dlrm_loss_grads_through_the_plain_bag_match_reference():
    """On the CPU the bag's plain version is differentiable, so every DLRM
    parameter (the tables too) gets the reference's gradient."""
    ref_cfg, cfg = ref_dlrm_cfg.smoke_config(), dlrm_mlperf.smoke_config()
    ref_params = ref_dlrm.dlrm_init(jax.random.PRNGKey(0), ref_cfg)
    params = dlrm_params_from_numpy(_numpy_tree(ref_params), device="cpu")
    ref_batch = ref_dlrm_cfg.smoke_batch(ref_cfg, 1)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in ref_batch.items()}
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: ref_dlrm.dlrm_loss(p, ref_batch, ref_cfg)))(ref_params)
    loss, got = value_and_grad(lambda p, b: dlrm.dlrm_loss(p, b, cfg), params, batch)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert float(got["tables"].abs().sum()) > 0
    _assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_embedding_bag_on_cpu_keeps_the_tables_gradient():
    eb = importlib.import_module("repro_torch.kernels.embedding_bag")
    table = torch.randn(10, 4, requires_grad=True)
    idx = torch.tensor([[1, 3], [3, 9]], dtype=torch.int32)
    out = eb.embedding_bag(table, idx, torch.ones(2, 2))
    (g,) = torch.autograd.grad(out.sum(), table)
    assert g[3].tolist() == [2.0] * 4 and g[0].tolist() == [0.0] * 4
