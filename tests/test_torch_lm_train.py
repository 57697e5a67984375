"""LM and DLRM training on repro_torch against the JAX package on the CPU.

`loss_fn`'s gradient for every LM arch against `jax.grad` (through the
chunked online softmax of `flash_attention` and, for the MoE archs, the
router), three AdamW steps' loss history against the reference's, mirrors
of the reference's smoke train / decode and fault-recovery tests, DLRM's
loss through the plain bag (never the op), `build_training` and `python -m
repro_torch.launch.train` for the `lm` and `recsys` families, `serve` for
the MoE archs, and the two example ports.  Tolerances: float32 at rtol /
atol 1e-4; losses at 1e-5.
"""
import importlib
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models.dlrm as ref_dlrm
import repro.models.transformer as ref_tfm
import repro.train.data as ref_data
from repro.train.adamw import AdamW as RefAdamW
from repro.train.loop import make_train_step as ref_make_train_step
from repro_torch import configs
from repro_torch.convert import dlrm_params_from_numpy, transformer_params_from_numpy
from repro_torch.launch import serve
from repro_torch.launch import train as train_cli
from repro_torch.models import dlrm
from repro_torch.models import transformer as tfm
from repro_torch.train import (
    AdamW,
    CheckpointManager,
    LoopConfig,
    TrainLoop,
    dlrm_batches,
    make_train_step,
    token_batches,
)
from repro_torch.train.loop import value_and_grad
from repro_torch.tree import tree_leaves

eb = importlib.import_module("repro_torch.kernels.embedding_bag")

ROOT = Path(__file__).resolve().parents[1]
T = torch.from_numpy
J = jnp.asarray
TOL = dict(rtol=1e-4, atol=1e-4)
LM_ARCHS = [a for a, s in ref_configs.ARCHS.items() if s.family == "lm"]
MOE_ARCHS = [a for a in LM_ARCHS if ref_configs.get_arch(a).full_config().n_experts]
ENV = {"PYTHONPATH": str(ROOT / "src"), "PATH": ""}


def _smoke(arch: str, seed: int = 0):
    cfg = configs.get_arch(arch).smoke_config()
    ref_cfg = ref_configs.get_arch(arch).smoke_config()
    ref_params = ref_tfm.init_params(jax.random.PRNGKey(seed), ref_cfg)
    params = transformer_params_from_numpy({k: np.asarray(v) for k, v in ref_params.items()},
                                           cfg, device="cpu")
    return cfg, ref_cfg, ref_params, params


def _batch(arch: str, cfg, seed: int = 0):
    batch = configs.get_arch(arch).smoke_batch(cfg, seed)
    return batch, {k: J(v.numpy()) for k, v in batch.items()}


# -------------------------------------------------------------- gradients

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_grads_match_jax_grad(arch):
    """Every parameter's gradient of `loss_fn` equals `jax.grad`'s, with
    the per-layer recompute on both sides (the reference's
    `jax.checkpoint`, the port's `torch.utils.checkpoint`)."""
    cfg, ref_cfg, ref_params, params = _smoke(arch, seed=5)
    batch, ref_batch = _batch(arch, cfg, 2)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: ref_tfm.loss_fn(p, ref_batch, ref_cfg)))(ref_params)
    loss, got = value_and_grad(lambda p, b: tfm.loss_fn(p, b, cfg), params, batch)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5, atol=1e-5)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(w), err_msg=key, **TOL)
        assert got[key].dtype == params[key].dtype
    assert all(float(g.abs().sum()) > 0 for k, g in got.items() if not k.endswith("norm"))


def test_forward_train_recomputes_each_layer_only_under_grad(monkeypatch):
    cfg, _, _, params = _smoke("moonshot-v1-16b-a3b")
    batch, _ = _batch("moonshot-v1-16b-a3b", cfg)
    calls = []
    real = tfm.checkpoint

    def counting(fn, *args, **kw):
        calls.append(kw)
        return real(fn, *args, **kw)

    monkeypatch.setattr(tfm, "checkpoint", counting)
    with torch.no_grad():
        plain = tfm.loss_fn(params, batch, cfg)
    assert calls == []
    loss, _ = value_and_grad(lambda p, b: tfm.loss_fn(p, b, cfg), params, batch)
    assert calls == [{"use_reentrant": False, "preserve_rng_state": False}] * cfg.n_layers
    assert torch.equal(loss, plain)


@pytest.mark.parametrize("arch", LM_ARCHS + ["dlrm-mlperf"])
def test_three_adamw_steps_match_reference(arch):
    """The loss history of three AdamW steps on the data pipeline's
    batches (`token_batches` 4 x 16, `dlrm_batches` 16 rows), from the
    reference's weights."""
    kw = dict(lr=1e-2, warmup_steps=2)
    ref_opt, opt = RefAdamW(**kw), AdamW(**kw)
    if arch == "dlrm-mlperf":
        cfg = configs.get_arch(arch).smoke_config()
        ref_cfg = ref_configs.get_arch(arch).smoke_config()
        ref_params = ref_dlrm.dlrm_init(jax.random.PRNGKey(0), ref_cfg)
        params = dlrm_params_from_numpy(jax.tree.map(np.asarray, ref_params), device="cpu")
        ref_loss = lambda p, b: ref_dlrm.dlrm_loss(p, b, ref_cfg)  # noqa: E731
        loss = lambda p, b: dlrm.dlrm_loss(p, b, cfg)  # noqa: E731
        ref_data_it = ref_data.dlrm_batches(ref_cfg, 16)
    else:
        cfg, ref_cfg, ref_params, params = _smoke(arch, seed=6)
        ref_loss = lambda p, b: ref_tfm.loss_fn(p, b, ref_cfg)  # noqa: E731
        loss = lambda p, b: tfm.loss_fn(p, b, cfg)  # noqa: E731
        ref_data_it = ref_data.token_batches(cfg.vocab, 4, 16)
    ref_step = jax.jit(ref_make_train_step(ref_loss, ref_opt))
    step = make_train_step(loss, opt)
    ref_state, state = ref_opt.init(ref_params), opt.init(params)
    want, got = [], []
    for _ in range(3):
        ref_batch = next(ref_data_it)
        batch = {k: T(np.array(v)) for k, v in ref_batch.items()}
        ref_params, ref_state, ref_m = ref_step(ref_params, ref_state, ref_batch)
        params, state, m = step(params, state, batch)
        want.append(float(ref_m["loss"]))
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert int(state.count) == 3


# ----------------------------------------- the reference's smoke tests

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_smoke_train_step(arch):
    """tests/test_models_smoke.py's train step on the port's own weights."""
    spec = configs.get_arch(arch)
    cfg = spec.smoke_config()
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    batch = spec.smoke_batch(cfg)
    opt = AdamW(lr=1e-3)
    params2, _, metrics = make_train_step(lambda p, b: tfm.loss_fn(p, b, cfg), opt)(
        params, opt.init(params), batch)
    assert math.isfinite(float(metrics["loss"])), arch
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(params2)), arch
    logits = tfm.forward_train(params, batch["tokens"], cfg)
    assert logits.shape == (*batch["tokens"].shape, cfg.vocab)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_smoke_decode(arch):
    spec = configs.get_arch(arch)
    cfg = spec.smoke_config()
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    cache = tfm.init_cache(cfg, batch=2, max_len=16, device="cpu")
    tok = torch.zeros((2, 1), dtype=torch.int32)
    for _ in range(3):
        logits, cache = tfm.forward_decode(params, tok, cache, cfg)
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
    assert logits.shape == (2, 1, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    assert int(cache["pos"][0]) == 3


def test_fault_recovery_loop(tmp_path):
    """tests/test_train_substrate.py's recovery check on h2o's smoke LM:
    two injected failures at step 6, restored from step 5's checkpoint."""
    cfg = configs.get_arch("h2o-danube-1.8b").smoke_config()
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    opt = AdamW(lr=1e-3)
    fails = {"n": 0}

    def hook(s):
        if s == 6 and fails["n"] < 2:
            fails["n"] += 1
            raise RuntimeError("injected node failure")

    loop = TrainLoop(make_train_step(lambda p, b: tfm.loss_fn(p, b, cfg), opt),
                     CheckpointManager(str(tmp_path)),
                     LoopConfig(total_steps=10, checkpoint_every=5, max_retries=3),
                     fault_hook=hook)
    state, hist = loop.run(params, opt.init(params),
                           token_batches(cfg.vocab, 4, 16, steps=30, device="cpu"))
    assert loop.retries == 2
    assert len(hist) >= 10 and np.isfinite(hist[-1])
    assert int(state[1].count) == 10


# ------------------------------------------------------------------- DLRM

def test_dlrm_loss_never_calls_the_op(monkeypatch):
    """The loss pools through `embedding_bag_plain` by choice, as the
    reference's does: with the op made to raise, the loss and its gradient
    still equal the reference's, and no kernel launch is counted."""
    def refuse(*args):
        raise AssertionError("dlrm_loss called the embedding_bag op")

    monkeypatch.setattr(dlrm, "embedding_bag", refuse)
    monkeypatch.setattr(eb, "embedding_bag", refuse)
    cfg = configs.get_arch("dlrm-mlperf").smoke_config()
    ref_cfg = ref_configs.get_arch("dlrm-mlperf").smoke_config()
    ref_params = ref_dlrm.dlrm_init(jax.random.PRNGKey(1), ref_cfg)
    params = dlrm_params_from_numpy(jax.tree.map(np.asarray, ref_params), device="cpu")
    ref_batch = ref_configs.get_arch("dlrm-mlperf").smoke_batch(ref_cfg, 3)
    batch = {k: T(np.array(v)) for k, v in ref_batch.items()}
    before = eb.launches
    loss, grads = value_and_grad(lambda p, b: dlrm.dlrm_loss(p, b, cfg), params, batch)
    assert eb.launches == before
    want = ref_dlrm.dlrm_loss(ref_params, ref_batch, ref_cfg)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5, atol=1e-6)
    assert float(grads["tables"].abs().sum()) > 0
    with pytest.raises(AssertionError, match="called the embedding_bag op"):
        dlrm.dlrm_forward(params, batch, cfg)


def test_train_loop_frees_each_steps_state(tmp_path):
    """With the cyclic garbage collector off, a DLRM step leaves only the
    current state alive: nothing on the step's path (the tree walks of
    `value_and_grad` and AdamW among them) holds the step before's tables
    in a reference cycle.  At 2^18 rows a table on the card each leftover
    copy is 3.25 GiB."""
    import gc
    import weakref

    cfg = configs.get_arch("dlrm-mlperf").smoke_config()
    params = dlrm.dlrm_init(torch.Generator().manual_seed(0), cfg)
    opt = AdamW(lr=1e-3)
    seen = []
    step = make_train_step(lambda p, b: dlrm.dlrm_loss(p, b, cfg), opt)

    def recording(p, o, b):
        out = step(p, o, b)
        seen.append(weakref.ref(out[0]["tables"]))
        return out

    loop = TrainLoop(recording, CheckpointManager(str(tmp_path)),
                     LoopConfig(total_steps=5, checkpoint_every=10))
    gc.disable()
    try:
        (params, state), hist = loop.run(params, opt.init(params),
                                         dlrm_batches(cfg, 16, steps=10, device="cpu"))
        alive = [r() is not None for r in seen]
    finally:
        gc.enable()
    assert len(hist) == 5 and alive == [False] * 4 + [True]


# ----------------------------------------------------------------- launch

@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "moonshot-v1-16b-a3b", "dlrm-mlperf"])
def test_build_training_trains_the_lm_and_recsys_families(arch):
    cfg, params, loss, data = train_cli.build_training(arch, "smoke", device="cpu")
    again = train_cli.build_training(arch, "smoke", device="cpu")[1]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params), tree_leaves(again)))
    batch = next(data)
    if arch == "dlrm-mlperf":
        assert batch["dense"].shape == (8, cfg.n_dense)
        want = next(ref_data.dlrm_batches(ref_configs.get_arch(arch).smoke_config(), 8))
    else:
        assert batch["tokens"].shape == (8, 128) and batch["labels"].shape == (8, 128)
        want = next(ref_data.token_batches(cfg.vocab, 8, 128))
    for key, w in want.items():
        np.testing.assert_array_equal(batch[key].numpy(), np.asarray(w))
    assert math.isfinite(float(loss(params, batch)))
    if arch != "dlrm-mlperf":
        small = next(train_cli.build_training(arch, "smoke", 4, 16, device="cpu")[3])
        assert small["tokens"].shape == (4, 16)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "llama4-scout-17b-a16e",
                                  "stablelm-3b", "dlrm-mlperf"])
def test_train_cli_trains_lm_and_recsys(arch, tmp_path, capsys):
    train_cli.main(["--arch", arch, "--steps", "3", "--batch", "4", "--seq", "16",
                    "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"arch={arch} device=cpu steps=3 loss ")
    first, last = (float(x) for x in line.split(" loss ")[1].split(" (")[0].split(" -> "))
    assert math.isfinite(first) and math.isfinite(last)


def test_python_m_train_runs_a_moe_arch_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "moonshot-v1-16b-a3b",
         "--steps", "3", "--batch", "2", "--seq", "16", "--device", "cpu",
         "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, cwd=ROOT, timeout=300, env=ENV)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("arch=moonshot-v1-16b-a3b device=cpu steps=3 loss ")


def _reference_serve_tokens(ref_params, cfg, batch, prompt_len, gen_tokens):
    """The reference's `serve_lm` loop (repro/launch/serve.py)."""
    prompts = jnp.asarray(np.random.default_rng(0).integers(0, cfg.vocab, (batch, prompt_len)),
                          jnp.int32)
    max_len = prompt_len + gen_tokens + 1
    logits, cache = jax.jit(lambda p, t: ref_tfm.forward_prefill(p, t, cfg, max_len))(
        ref_params, prompts)
    decode = jax.jit(lambda p, t, c: ref_tfm.forward_decode(p, t, c, cfg))
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    out = [tok]
    for _ in range(gen_tokens):
        logits, cache = decode(ref_params, tok, cache)
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_lm_moe_on_cpu_matches_reference_loop(arch):
    cfg, ref_cfg, ref_params, params = _smoke(arch, seed=3)
    want = _reference_serve_tokens(ref_params, ref_cfg, 4, 32, 16)
    res = serve.serve_lm(cfg, 4, 32, 16, device="cpu", params=params)
    np.testing.assert_array_equal(res.tokens, want)
    assert res.logits.shape == (4, 1, cfg.vocab) and bool(torch.isfinite(res.logits).all())


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_serve_cli_serves_every_lm_arch(arch, capsys):
    serve.main(["--arch", arch, "--device", "cpu", "--batch", "2", "--prompt", "8",
                "--tokens", "3"])
    assert capsys.readouterr().out.startswith(f"arch={arch} device=cpu batch=2 ")


def test_python_m_serve_runs_a_moe_arch_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "llama4-scout-17b-a16e",
         "--device", "cpu", "--tokens", "4"],
        capture_output=True, text=True, cwd=ROOT, timeout=300, env=ENV)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("arch=llama4-scout-17b-a16e device=cpu batch=4 ")


# --------------------------------------------------------------- examples

@pytest.mark.parametrize("script,args", [
    ("serve_decode_torch.py", []),
    ("serve_decode_torch.py", ["--arch", "moonshot-v1-16b-a3b"]),
    ("train_lm_e2e_torch.py", ["--steps", "12", "--layers", "2", "--seq", "32"]),
], ids=["serve_decode", "serve_decode_moe", "train_lm_e2e"])
def test_example_ends_ok_on_the_cpu(script, args):
    out = subprocess.run([sys.executable, str(ROOT / "examples" / script), "--device", "cpu",
                          *args], capture_output=True, text=True, cwd=ROOT, timeout=300,
                         env=ENV)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1].startswith("OK")


@pytest.mark.parametrize("script", ["serve_decode_torch.py", "train_lm_e2e_torch.py"])
def test_example_defaults_to_the_card(script):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works here")
    out = subprocess.run([sys.executable, str(ROOT / "examples" / script)],
                         capture_output=True, text=True, cwd=ROOT, timeout=300, env=ENV)
    assert out.returncode != 0 and "no CUDA device" in out.stderr

