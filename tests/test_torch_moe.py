"""repro_torch's mixture-of-experts layer and the five LM archs against the
JAX package on the CPU.

The MoE pieces (`_moe_dispatch`, `_moe_pack`, `_moe_expert_mlp`,
`_moe_combine`, `_moe_cap`, `moe_ffn`) on the same numpy inputs; the
dispatch's integers (slots, token ids, keep) exactly equal, with capacity
drops and with router columns duplicated so that probabilities tie; every
LM arch's configs, parameter counts, `forward_train`, `loss_fn`, prefill
and greedy decode from the reference's weights.  Tolerances: float32 at
rtol / atol 1e-4; the routing weights at 1e-6.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models.transformer as ref_tfm
from repro_torch import configs
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.models import transformer as tfm

T = torch.from_numpy
J = jnp.asarray
TOL = dict(rtol=1e-4, atol=1e-4)
LM_ARCHS = [a for a, s in ref_configs.ARCHS.items() if s.family == "lm"]
MOE_ARCHS = [a for a in LM_ARCHS if ref_configs.get_arch(a).full_config().n_experts]


def _smoke(arch: str, seed: int = 0, **replace):
    """(port cfg, ref cfg, ref params, port params) of `arch`'s smoke
    config, the reference's weights carried across."""
    cfg = dataclasses.replace(configs.get_arch(arch).smoke_config(), **replace)
    ref_cfg = dataclasses.replace(ref_configs.get_arch(arch).smoke_config(), **replace)
    ref_params = ref_tfm.init_params(jax.random.PRNGKey(seed), ref_cfg)
    params = transformer_params_from_numpy({k: np.asarray(v) for k, v in ref_params.items()},
                                           cfg, device="cpu")
    return cfg, ref_cfg, ref_params, params


# --------------------------------------------------------------- dispatch

def _router_case(t, d, e, seed, tied):
    """x (T, d) and a router (d, E); with `tied`, every odd expert's column
    is a copy of the even one before it, so their probabilities tie."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d)).astype(np.float32)
    router = (rng.standard_normal((d, e)) / np.sqrt(d)).astype(np.float32)
    if tied:
        router[:, 1::2] = router[:, 0::2]
    return x, router


# (T, d, E, k, capacity factor, tied): no drops, drops, moonshot's E and k
# with ties, top-1 with ties, ties with drops, and a decode-sized T (cap 4)
DISPATCH_CASES = [
    (64, 32, 8, 2, 1.25, False),
    (64, 32, 8, 2, 0.25, False),
    (48, 16, 64, 6, 1.25, True),
    (37, 16, 16, 1, 1.25, True),
    (40, 16, 8, 3, 0.3, True),
    (4, 32, 64, 6, 1.25, False),
]


@pytest.mark.parametrize("t,d,e,k,cf,tied", DISPATCH_CASES)
def test_moe_dispatch_matches_reference(t, d, e, k, cf, tied):
    x, router = _router_case(t, d, e, seed=t + e, tied=tied)
    cap = tfm._moe_cap(t, k, e, cf)
    want = ref_tfm._moe_dispatch(J(x), J(router), e, k, cap)
    got = tfm._moe_dispatch(T(x), T(router), e, k, cap)
    for name, w, g in zip(("slot", "token", "keep"), (want[0], want[1], want[3]),
                          (got[0], got[1], got[3])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-6, atol=1e-6)
    keep = got[3].numpy()
    if cf < 1:
        assert not keep.all(), "the case should drop tokens"
    if tied:
        logits = (T(x) @ T(router)).numpy()
        np.testing.assert_array_equal(logits[:, 1::2], logits[:, 0::2])
        chosen = (got[0][keep.reshape(-1)] // cap).numpy()
        # of two tied experts the lower is taken first: where a pair's odd
        # member is chosen, so is its even one
        odd = chosen[chosen % 2 == 1]
        assert set((odd - 1).tolist()) <= set(chosen.tolist())


def test_top_k_takes_the_lower_index_on_ties():
    probs = torch.tensor([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25]])
    p, i = tfm._top_k(probs, 3)
    assert i.tolist() == [[1, 2, 0], [0, 1, 2]]
    want_p, want_i = jax.lax.top_k(J(probs.numpy()), 3)
    np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(p.numpy(), np.asarray(want_p))


@pytest.mark.parametrize("cf", [0.25, 1.0, 1.25, 2.0])
def test_moe_cap_matches_reference(cf):
    for t, k, e in itertools.product((1, 2, 3, 4, 7, 64, 1000, 4096), (1, 2, 6), (4, 8, 16, 64)):
        assert tfm._moe_cap(t, k, e, cf) == ref_tfm._moe_cap(t, k, e, cf), (t, k, e, cf)


@pytest.mark.parametrize("cf,tied", [(1.25, False), (0.25, False), (0.3, True)])
def test_moe_pack_and_combine_match_reference(cf, tied):
    t, d, e, k = 40, 16, 8, 3
    x, router = _router_case(t, d, e, seed=5, tied=tied)
    cap = tfm._moe_cap(t, k, e, cf)
    fs, ft, fw, keep = ref_tfm._moe_dispatch(J(x), J(router), e, k, cap)
    port = [T(np.array(a)) for a in (fs, ft, fw, keep)]
    port[0], port[1] = port[0].long(), port[1].long()
    buf = tfm._moe_pack(T(x), port[0], port[1], port[3], e, cap)
    want_buf = ref_tfm._moe_pack(J(x), fs, ft, keep, e, cap)
    assert buf.shape == (e, cap, d)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(want_buf))
    out_buf = np.random.default_rng(6).standard_normal((e * cap, d)).astype(np.float32)
    got = tfm._moe_combine(T(out_buf), port[0], port[1], port[2], t, d, e, cap, torch.float32)
    want = ref_tfm._moe_combine(J(out_buf), fs, ft, fw, t, d, e, cap, jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_moe_expert_mlp_matches_reference():
    rng = np.random.default_rng(7)
    e, cap, d, f = 4, 12, 16, 24
    buf, w1, w3, w2 = (rng.standard_normal(s).astype(np.float32) / 4
                       for s in ((e, cap, d), (e, d, f), (e, d, f), (e, f, d)))
    got = tfm._moe_expert_mlp(T(buf), T(w1), T(w3), T(w2))
    want = ref_tfm._moe_expert_mlp(J(buf), J(w1), J(w3), J(w2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shared", [2, 0])
@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_moe_ffn_matches_reference(shared, cf):
    """moonshot's smoke layer 0, with and without its shared experts, and
    at a capacity factor that drops tokens."""
    cfg, ref_cfg, ref_params, params = _smoke("moonshot-v1-16b-a3b", seed=3,
                                              n_shared_experts=shared, capacity_factor=cf)
    assert ("shared_w1" in params) == bool(shared)
    x3 = np.random.default_rng(8).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    ref_layer = {k: v[0] for k, v in ref_tfm._split_layers(ref_params)[0].items()}
    want = ref_tfm.moe_ffn(J(x3), ref_layer, ref_cfg)
    got = tfm.moe_ffn(T(x3), tfm._layers(params)[0], cfg)
    assert got.shape == x3.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.equal(got, tfm.moe_ffn(T(x3), tfm._layers(params)[0], cfg))  # a rerun: same bits


def test_moe_gradients_reach_router_and_experts():
    cfg, ref_cfg, ref_params, params = _smoke("moonshot-v1-16b-a3b", seed=4)
    x3 = np.random.default_rng(9).standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    ref_layer = {k: v[0] for k, v in ref_tfm._split_layers(ref_params)[0].items()}
    want_x, want_l = jax.grad(lambda x, p: jnp.sum(ref_tfm.moe_ffn(x, p, ref_cfg) ** 2),
                              argnums=(0, 1))(J(x3), ref_layer)
    layer = {k: v.clone().requires_grad_(True) for k, v in tfm._layers(params)[0].items()}
    x = T(x3).requires_grad_(True)
    (tfm.moe_ffn(x, layer, cfg) ** 2).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_x), **TOL)
    for key in ("router", "moe_w1", "moe_w2", "moe_w3", "shared_w1", "shared_w2"):
        np.testing.assert_allclose(layer[key].grad.numpy(), np.asarray(want_l[key]),
                                   err_msg=key, **TOL)
    assert float(layer["router"].grad.abs().sum()) > 0


def test_moe_load_is_spread():
    """tests/test_models_smoke.py's check: with random inputs, more than
    half the experts receive tokens."""
    cfg = configs.get_arch("moonshot-v1-16b-a3b").smoke_config()
    gen = torch.Generator().manual_seed(0)
    params = tfm.init_params(gen, cfg)
    x = torch.randn((64, cfg.d_model), generator=gen)
    probs = torch.softmax((x @ params["router"][0]).float(), dim=-1)
    used = torch.unique(tfm._top_k(probs, cfg.top_k)[1])
    assert used.numel() > cfg.n_experts // 2


# ---------------------------------------------------------------- configs

def test_registry_has_the_references_archs():
    assert list(configs.ARCHS) == list(ref_configs.ARCHS)
    assert [s.family for s in configs.ARCHS.values()] == \
        [s.family for s in ref_configs.ARCHS.values()]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_configs_and_counts_match_reference(arch):
    spec, ref_spec = configs.get_arch(arch), ref_configs.get_arch(arch)
    for name in ("full_config", "smoke_config"):
        cfg, ref_cfg = getattr(spec, name)(), getattr(ref_spec, name)()
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg), name
        assert cfg.param_count() == ref_cfg.param_count(), name
        assert cfg.active_param_count() == ref_cfg.active_param_count(), name
        assert cfg.d_head == ref_cfg.d_head
    assert {k: dataclasses.asdict(v) for k, v in spec.shapes.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_spec.shapes.items()}
    full = spec.full_config()
    for shape in spec.shapes.values():
        want = ref_spec.input_specs(ref_spec.full_config(), ref_spec.shapes[shape.name])
        got = spec.input_specs(full, shape)
        flat_want = jax.tree.leaves(want, is_leaf=lambda x: hasattr(x, "shape"))
        flat_got = jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, tuple))
        assert [tuple(w.shape) for w in flat_want] == [tuple(g[0]) for g in flat_got]
    batch, ref_batch = spec.smoke_batch(spec.smoke_config(), 3), \
        ref_spec.smoke_batch(ref_spec.smoke_config(), 3)
    for key in ("tokens", "labels"):
        np.testing.assert_array_equal(batch[key].numpy(), np.asarray(ref_batch[key]))


def test_full_width_sizes():
    """moonshot's config holds 28.9 B parameters; only it and stablelm fit
    one 80 GB card whole in bf16."""
    counts = {a: configs.get_arch(a).full_config().param_count() for a in LM_ARCHS}
    assert counts["moonshot-v1-16b-a3b"] == 28_888_467_456
    assert configs.get_arch("moonshot-v1-16b-a3b").full_config().active_param_count() == \
        4_804_773_888
    assert counts["stablelm-3b"] == 2_795_276_800
    assert counts["llama4-scout-17b-a16e"] == 107_769_861_120
    assert counts["command-r-plus-104b"] == 106_956_337_152
    assert {a for a, n in counts.items() if 2 * n < 80e9} == \
        {"moonshot-v1-16b-a3b", "stablelm-3b", "h2o-danube-1.8b"}


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_init_params_shapes_match_reference(arch):
    cfg, _, ref_params, _ = _smoke(arch)
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: tuple(v.shape) for k, v in ref_params.items()}
    assert sum(v.numel() for v in params.values()) == cfg.param_count()


def test_init_params_draws_a_block_of_rows_at_a_time(monkeypatch):
    """Each tensor is filled in blocks of at most `_DRAW_CHUNK` float32
    elements, in the config's dtype: normal / sqrt(fan_in) whatever the
    block size."""
    cfg = dataclasses.replace(configs.get_arch("moonshot-v1-16b-a3b").smoke_config(),
                              dtype="bfloat16")
    draws = []
    real_randn = torch.randn

    def recording(shape, **kw):
        draws.append(int(np.prod(shape)))
        return real_randn(shape, **kw)

    monkeypatch.setattr(tfm, "_DRAW_CHUNK", 1000)
    monkeypatch.setattr(torch, "randn", recording)
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    assert max(draws) <= 1000 and sum(draws) == cfg.param_count() - cfg.d_model * (
        2 * cfg.n_layers + 1)  # the norms are ones
    w1 = params["moe_w1"]
    assert w1.dtype == torch.bfloat16 and w1.shape == (2, 8, 64, 48)
    assert abs(float(w1.float().std()) * np.sqrt(cfg.d_model) - 1) < 0.05


def test_bfloat16_moe_weights_cross_exactly():
    cfg, _, ref_params, params = _smoke("moonshot-v1-16b-a3b", seed=2, dtype="bfloat16")
    assert {"router", "moe_w1", "moe_w2", "moe_w3", "shared_w1"} <= set(params)
    for k, v in ref_params.items():
        assert params[k].dtype == torch.bfloat16, k
        np.testing.assert_array_equal(params[k].float().numpy(), np.asarray(v, np.float32))


# -------------------------------------------------------- the whole model

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_train_and_loss_match_reference(arch):
    cfg, ref_cfg, ref_params, params = _smoke(arch)
    batch = configs.get_arch(arch).smoke_batch(cfg, 1)
    ref_batch = {k: J(v.numpy()) for k, v in batch.items()}
    want = ref_tfm.forward_train(ref_params, ref_batch["tokens"], ref_cfg)
    got = tfm.forward_train(params, batch["tokens"], cfg)
    assert got.shape == (2, 32, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(tfm.loss_fn(params, batch, cfg)),
                               float(ref_tfm.loss_fn(ref_params, ref_batch, ref_cfg)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_and_greedy_decode_match_reference(arch):
    """A 32-token prompt, then 6 greedy steps: the prefill's logits and
    cache, each step's logits and each token equal the reference's.  For
    the MoE archs this is the only decode check: a decode step's capacity
    is that of B tokens, so it is another function than forward_train."""
    cfg, ref_cfg, ref_params, params = _smoke(arch, seed=1)
    toks = np.random.default_rng(11).integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    max_len = 32 + 6 + 1
    want_logits, want_cache = ref_tfm.forward_prefill(ref_params, J(toks), ref_cfg, max_len)
    logits, cache = tfm.forward_prefill(params, T(toks), cfg, max_len)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(want_cache[key]), **TOL)
    for step in range(7):
        np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), err_msg=str(step),
                                   **TOL)
        want_tok = np.asarray(jnp.argmax(want_logits[:, -1], -1))[:, None].astype(np.int32)
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        np.testing.assert_array_equal(tok.numpy(), want_tok, err_msg=f"step {step}")
        if step == 6:
            break
        want_logits, want_cache = ref_tfm.forward_decode(ref_params, J(want_tok), want_cache,
                                                         ref_cfg)
        logits, cache = tfm.forward_decode(params, tok, cache, cfg)
    assert int(cache["pos"][0]) == 38 == int(want_cache["pos"][0])
