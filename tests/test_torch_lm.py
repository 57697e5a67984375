"""repro_torch's LM serving path against the JAX package on the CPU.

Inputs are drawn with numpy from a seed and go through both packages: the
sliding-window decode attention (the port's plain version, which its
wrapper takes for CPU tensors, against both JAX routes: the Pallas kernel
in interpret mode and the jnp reference), the attention pieces, the
h2o-danube smoke transformer with the reference's weights carried across,
and the serving loop.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.h2o_danube_1_8b as ref_danube
import repro.configs.lm_common as ref_lm_common
import repro.kernels.ops as ref_ops
import repro.kernels.ref as ref_kref
import repro.models.attention as ref_attn
import repro.models.common as ref_common
import repro.models.transformer as ref_tfm
import repro_torch.configs.h2o_danube_1_8b as danube
import repro_torch.configs.lm_common as lm_common
from repro_torch.configs import get_arch
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.kernels import swa_attention as sw
from repro_torch.launch import serve
from repro_torch.models import attention, common
from repro_torch.models import transformer as tfm

T = torch.from_numpy
J = jnp.asarray

# (d_head, cache length, window, pos per batch row): tests/test_kernels.py's
# cases, then pos = 0 everywhere, ragged pos past the window, a window equal
# to the cache and a window wider than it
SWA_CASES = [
    (64, 256, 64, (100, 200)), (80, 512, 128, (0, 512)), (128, 128, 256, (64, 127)),
    (80, 64, 16, (0, 0)), (80, 300, 32, (5, 299)), (64, 96, 96, (96, 40)),
    (80, 64, 4096, (64, 13)),
]


@pytest.mark.parametrize("use_kernel", [True, False], ids=["pallas", "jnp"])
@pytest.mark.parametrize("dh,s,win,pos", SWA_CASES)
def test_swa_plain_matches_both_jax_routes(dh, s, win, pos, use_kernel):
    rng = np.random.default_rng(dh + s + win)
    b, kvh, g = 2, 4, 3
    q = rng.standard_normal((b, kvh, g, dh)).astype(np.float32)
    kc = rng.standard_normal((b, s, kvh, dh)).astype(np.float32)
    vc = rng.standard_normal((b, s, kvh, dh)).astype(np.float32)
    p = np.asarray(pos, np.int32)
    want = ref_ops.swa_attention_decode(J(q), J(kc), J(vc), J(p), window=win,
                                        use_kernel=use_kernel)
    before = sw.launches
    got = sw.swa_attention_decode(T(q), T(kc), T(vc), T(p), window=win)
    assert sw.launches == before  # CPU tensors take the plain version
    assert got.shape == (b, kvh, g, dh) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4, atol=3e-4)
    if max(pos) == 0:
        assert not got.any()  # an empty window gives zeros, not NaN


def test_swa_matches_full_decode_attention_when_window_covers():
    rng = np.random.default_rng(1)
    b, kvh, g, dh, s = 2, 2, 2, 32, 64
    q = rng.standard_normal((b, kvh, g, dh)).astype(np.float32)
    kc = rng.standard_normal((b, s, kvh, dh)).astype(np.float32)
    vc = rng.standard_normal((b, s, kvh, dh)).astype(np.float32)
    pos = np.array([40, 64], np.int32)
    out = sw.swa_attention_decode(T(q), T(kc), T(vc), T(pos), window=s)
    full = attention.decode_attention(T(q.reshape(b, 1, kvh * g, dh)), T(kc), T(vc), T(pos))
    np.testing.assert_allclose(out.reshape(b, kvh * g, dh).numpy(), full[:, 0].numpy(),
                               rtol=3e-4, atol=3e-4)


def test_swa_wrapper_rejects_bad_inputs():
    q = torch.zeros(2, 2, 2, 16)
    kc = torch.zeros(2, 8, 2, 16)
    # an integer pos of another type is taken as int32, as the reference's
    # op takes it; a fill level past int32, or a float pos, is refused
    torch.testing.assert_close(
        sw.swa_attention_decode(q, kc, kc, torch.tensor([3, 8]), window=4),
        sw.swa_attention_decode(q, kc, kc, torch.tensor([3, 8], dtype=torch.int32), window=4),
        rtol=0, atol=0)
    with pytest.raises(ValueError, match="int32"):
        sw.swa_attention_decode(q, kc, kc, torch.tensor([3, 2**31]), window=4)
    with pytest.raises(ValueError, match="int32"):
        sw.swa_attention_decode(q, kc, kc, torch.zeros(2), window=4)
    with pytest.raises(ValueError, match="does not match"):
        sw.swa_attention_decode(torch.zeros(2, 3, 2, 16), kc, kc,
                                torch.zeros(2, dtype=torch.int32), window=4)
    with pytest.raises(TypeError):
        sw.swa_attention_decode(q.double(), kc.double(), kc.double(),
                                torch.zeros(2, dtype=torch.int32), window=4)
    with pytest.raises(ValueError, match="window"):
        sw.swa_attention_decode(q, kc, kc, torch.zeros(2, dtype=torch.int32), window=-1)


# (span, B·KVH rows, G, SMs): the serve shape, decode_32k, G = 16 over 8192,
# a window no multiple of a tile, one position, an empty window, few rows
PLAN_CASES = [(4096, 32, 4, 132), (4096, 1024, 4, 132), (8192, 1, 16, 132),
              (2500, 24, 4, 132), (1, 8, 1, 132), (0, 8, 4, 132), (300, 4, 3, 2)]


@pytest.mark.parametrize("span,rows,groups,sms", PLAN_CASES)
def test_swa_split_plan_covers_every_window_once(span, rows, groups, sms):
    splits, chunk = sw.split_plan(span, rows, groups, sms)
    assert splits >= 1 and chunk >= sw.TILE and chunk % sw.TILE == 0
    assert groups * chunk <= max(sw.SCORE_FLOATS, groups * sw.TILE)  # scores fit
    assert splits * chunk >= span and (splits - 1) * chunk < max(span, 1)  # no idle tail
    # every row's [lo, hi), ragged pos included, is covered exactly once (a
    # window of `span` in a cache of 2·span + 3)
    seq = 2 * span + 3
    for pos in range(0, seq + 3, max(1, span // 7)):
        lo, hi = max(0, pos - span), min(pos, seq)
        covered = np.zeros(max(hi - lo, 0), np.int64)
        for i in range(splits):
            a, z = lo + i * chunk, min(hi, lo + (i + 1) * chunk)
            covered[max(a, lo) - lo:max(z, a) - lo] += 1
        assert (covered == 1).all()


def test_swa_split_plan_fills_the_card():
    assert sw.split_plan(4096, 32, 4, 132) == (16, 256)  # serve: 512 blocks
    assert sw.split_plan(4096, 1024, 4, 132) == (4, 1024)  # decode_32k
    splits, chunk = sw.split_plan(4096, 32, 4, 66)  # half the SMs: half the splits
    assert (splits, chunk) == (8, 512)


def _split_combine(q, kc, vc, pos, window, splits, chunk):
    """The kernels' arithmetic in torch float32: per split the chunk's max m,
    l = Σ exp(s - m) and o = Σ exp(s - m)·v, then the combine in split order
    with weight 0 for an empty split."""
    b, s, kvh, d = kc.shape
    scale = 1.0 / float(d) ** 0.5
    pos = pos.long()
    lo, hi = (pos - window).clamp(min=0), pos.clamp(max=s)
    rows = torch.arange(b)[:, None]
    ms, ls, os_ = [], [], []
    for i in range(splits):
        idx = lo[:, None] + i * chunk + torch.arange(chunk)
        valid = (idx < hi[:, None])[:, None, None, :]
        kw, vw = (c[rows, idx.clamp(max=s - 1)].float() for c in (kc, vc))
        sc = torch.einsum("bhgd,bwhd->bhgw", q.float(), kw) * scale
        sc = torch.where(valid, sc, -torch.inf)
        m = sc.amax(-1)
        e = torch.where(valid, torch.exp(sc - m[..., None]), 0.0)
        ms.append(m)
        ls.append(e.sum(-1))
        os_.append(torch.einsum("bhgw,bwhd->bhgd", e, vw))
    big = torch.stack(ms).amax(0)
    den = torch.zeros_like(big)
    acc = torch.zeros_like(os_[0])
    for m, l, o in zip(ms, ls, os_):
        w = torch.where(m == -torch.inf, 0.0, torch.exp(m - big))
        den = den + l * w
        acc = acc + o * w[..., None]
    return (acc / den.clamp(min=1e-30)[..., None]).to(q.dtype)


# (d_head, cache length, window, pos per row): ragged rows with empty splits,
# pos mid-chunk, one empty row among full ones, every row empty, window 0
SPLIT_CASES = [(80, 700, 256, (600, 300, 256, 3)), (64, 300, 200, (300, 0, 150, 77)),
               (80, 64, 4096, (0, 0, 0, 0)), (80, 64, 0, (10, 20, 30, 64))]


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("dh,s,win,pos", SPLIT_CASES)
def test_swa_split_combine_matches_the_jax_oracle(dh, s, win, pos, splits):
    rng = np.random.default_rng(dh + s + win + splits)
    b, kvh, g = len(pos), 2, 4
    q = rng.standard_normal((b, kvh, g, dh)).astype(np.float32)
    kc = rng.standard_normal((b, s, kvh, dh)).astype(np.float32)
    vc = rng.standard_normal((b, s, kvh, dh)).astype(np.float32)
    p = np.asarray(pos, np.int32)
    span = min(win, s)
    chunk = max(1, -(-span // splits))
    got = _split_combine(T(q), T(kc), T(vc), T(p), win, splits, chunk)
    assert not torch.isnan(got).any()
    want = ref_kref.swa_attention_decode_ref(J(q), J(kc.transpose(0, 2, 1, 3)),
                                             J(vc.transpose(0, 2, 1, 3)), J(p),
                                             jnp.zeros(b, jnp.int32), window=win)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    empty = np.minimum(p, s) <= np.maximum(p - win, 0)
    assert not got[torch.from_numpy(empty)].any()  # exact zeros where the window is empty
    # the plan's own split count agrees too
    plan_splits, plan_chunk = sw.split_plan(span, b * kvh, g, 132)
    np.testing.assert_allclose(
        _split_combine(T(q), T(kc), T(vc), T(p), win, plan_splits, plan_chunk).numpy(),
        np.asarray(want), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------- attention pieces

def test_rope_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    pos = np.stack([np.arange(12), np.arange(100, 112)]).astype(np.int32)
    want = ref_attn.rope(J(x), J(pos), 10000.0)
    got = attention.rope(T(x), T(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_rms_norm_and_cross_entropy_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(common.rms_norm(T(x), T(scale)).numpy(),
                               np.asarray(ref_common.rms_norm(J(x), J(scale))),
                               rtol=1e-5, atol=1e-5)
    logits = rng.standard_normal((3, 5, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) > 0.3).astype(np.float32)
    for m in (None, mask):
        want = ref_common.cross_entropy_loss(J(logits), J(labels), None if m is None else J(m))
        got = common.cross_entropy_loss(T(logits), T(labels), None if m is None else T(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [None, 5, 64])
def test_decode_attention_matches_reference(window):
    rng = np.random.default_rng(4)
    b, s, kvh, g, d = 3, 40, 2, 3, 16
    q = rng.standard_normal((b, 1, kvh * g, d)).astype(np.float32)
    kc = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    vc = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    pos = np.array([0, 17, 40], np.int32)
    want = ref_attn.decode_attention(J(q), J(kc), J(vc), J(pos), window=window)
    got = attention.decode_attention(T(q), T(kc), T(vc), T(pos), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sq,skv,window,q_offset,causal", [
    (32, 32, 8, 0, True),     # sliding window
    (37, 37, None, 0, True),  # kv padding: S not a multiple of kv_chunk
    (37, 37, 11, 0, True),    # window and padding
    (16, 48, 20, 32, True),   # q_offset > 0 (prefill continuation)
    (20, 45, None, 0, False),  # no mask but the padding
])
def test_flash_attention_matches_reference(sq, skv, window, q_offset, causal):
    rng = np.random.default_rng(sq + skv)
    b, h, kvh, d = 2, 4, 2, 16
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, kvh, d)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_chunk=8, kv_chunk=16, q_offset=q_offset)
    want = ref_attn.flash_attention(J(q), J(k), J(v), **kw)
    got = attention.flash_attention(T(q), T(k), T(v), **kw)
    assert got.shape == (b, sq, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ transformer

def _smoke():
    cfg = danube.smoke_config()
    ref_params = ref_tfm.init_params(jax.random.PRNGKey(0), ref_danube.smoke_config())
    params = transformer_params_from_numpy(
        {k: np.asarray(v) for k, v in ref_params.items()}, cfg, device="cpu")
    return cfg, ref_params, params


def test_configs_match_reference():
    for name in ("full_config", "smoke_config"):
        port_cfg = dataclasses.asdict(getattr(danube, name)())
        ref_cfg = dataclasses.asdict(getattr(ref_danube, name)())
        assert port_cfg == ref_cfg, name
    full = danube.full_config()
    assert full.param_count() == ref_danube.full_config().param_count()
    assert full.d_head == 80 and full.torch_dtype == torch.bfloat16
    spec = get_arch("h2o-danube-1.8b")
    ref_spec = ref_danube.SPEC
    assert spec.shapes == {k: lm_common.ShapeDef(**dataclasses.asdict(v))
                           for k, v in ref_spec.shapes.items()}
    for shape in spec.shapes.values():
        want = ref_lm_common.lm_input_specs(ref_danube.full_config(), ref_spec.shapes[shape.name])
        got = spec.input_specs(full, shape)
        flat_want = jax.tree.leaves(want, is_leaf=lambda x: hasattr(x, "shape"))
        flat_got = [v for v in jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, tuple))]
        assert [tuple(w.shape) for w in flat_want] == [tuple(g[0]) for g in flat_got]
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


def test_smoke_batch_and_init_params_shapes_match_reference():
    cfg, ref_params, _ = _smoke()
    batch = lm_common.lm_smoke_batch(cfg, seed=5)
    ref_batch = ref_lm_common.lm_smoke_batch(ref_danube.smoke_config(), seed=5)
    for key in ("tokens", "labels"):
        np.testing.assert_array_equal(batch[key].numpy(), np.asarray(ref_batch[key]))
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: tuple(v.shape) for k, v in ref_params.items()}
    assert all(v.dtype == torch.float32 for v in params.values())
    state = lm_common.lm_smoke_decode_state(cfg, batch=2, max_len=16, device="cpu")
    ref_state = ref_lm_common.lm_smoke_decode_state(ref_danube.smoke_config(), 2, 16)
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in ref_state.items()}


def test_forward_train_and_loss_match_reference():
    cfg, ref_params, params = _smoke()
    batch = lm_common.lm_smoke_batch(cfg)
    ref_batch = ref_lm_common.lm_smoke_batch(ref_danube.smoke_config())
    want = ref_tfm.forward_train(ref_params, ref_batch["tokens"], ref_danube.smoke_config())
    got = tfm.forward_train(params, batch["tokens"], cfg)
    assert got.shape == (2, 32, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    loss = tfm.loss_fn(params, batch, cfg)
    ref_loss = ref_tfm.loss_fn(ref_params, ref_batch, ref_danube.smoke_config())
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5, atol=1e-5)


def test_forward_prefill_matches_reference():
    cfg, ref_params, params = _smoke()
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    want_logits, want_cache = ref_tfm.forward_prefill(ref_params, J(toks),
                                                      ref_danube.smoke_config(), 41)
    logits, cache = tfm.forward_prefill(params, T(toks), cfg, 41)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=1e-4, atol=1e-4)
    for key in ("k", "v"):
        assert cache[key].shape == want_cache[key].shape
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(want_cache[key]),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(want_cache["pos"]))


@pytest.mark.parametrize("use_kernel", [True, False], ids=["pallas", "jnp"])
def test_decode_past_the_window_matches_reference(use_kernel, monkeypatch):
    """A 32-token prompt, then 8 greedy decode steps past the smoke window
    of 16: each step's logits and token equal the reference's."""
    monkeypatch.setattr(ref_tfm, "swa_attention_decode",
                        functools.partial(ref_ops.swa_attention_decode, use_kernel=use_kernel))
    cfg, ref_params, params = _smoke()
    ref_cfg = ref_danube.smoke_config()
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    max_len = 32 + 8 + 1
    want_logits, want_cache = ref_tfm.forward_prefill(ref_params, J(toks), ref_cfg, max_len)
    logits, cache = tfm.forward_prefill(params, T(toks), cfg, max_len)
    for step in range(8):
        want_tok = np.asarray(jnp.argmax(want_logits[:, -1], -1))[:, None].astype(np.int32)
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        np.testing.assert_array_equal(tok.numpy(), want_tok, err_msg=f"step {step}")
        want_logits, want_cache = ref_tfm.forward_decode(ref_params, J(want_tok), want_cache,
                                                         ref_cfg)
        logits, cache = tfm.forward_decode(params, tok, cache, cfg)
        np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=1e-4,
                                   atol=1e-4, err_msg=f"step {step}")
    assert int(cache["pos"][0]) == 40 > cfg.sliding_window


@pytest.mark.parametrize("swa_mode", ["window_kernel", "masked_full"])
def test_decode_matches_own_train_forward(swa_mode):
    """Incremental decode from an empty cache equals the training forward
    pass, past the window (mirrors the reference's
    test_lm_decode_matches_train_forward)."""
    cfg = dataclasses.replace(danube.smoke_config(), decode_swa_mode=swa_mode)
    params = tfm.init_params(torch.Generator().manual_seed(1), cfg)
    toks = T(np.random.default_rng(8).integers(0, cfg.vocab, (2, 24)).astype(np.int32))
    full = tfm.forward_train(params, toks, cfg)
    cache = tfm.init_cache(cfg, 2, 32, device="cpu")
    outs = []
    for t in range(24):
        lt, cache = tfm.forward_decode(params, toks[:, t:t + 1], cache, cfg)
        outs.append(lt)
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_bfloat16_params_cross_exactly():
    cfg = dataclasses.replace(danube.smoke_config(), dtype="bfloat16")
    ref_params = ref_tfm.init_params(
        jax.random.PRNGKey(2), dataclasses.replace(ref_danube.smoke_config(), dtype="bfloat16"))
    params = transformer_params_from_numpy({k: np.asarray(v) for k, v in ref_params.items()},
                                           cfg, device="cpu")
    for k, v in ref_params.items():
        assert params[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(params[k].float().numpy(), np.asarray(v, np.float32))


# ---------------------------------------------------------------- serving

def _reference_serve_tokens(ref_params, cfg, batch, prompt_len, gen_tokens):
    """The reference's `serve_lm` loop (repro/launch/serve.py), returning
    its tokens."""
    rng = np.random.default_rng(0)
    prompts = jnp.asarray(rng.integers(0, cfg.vocab, (batch, prompt_len)), jnp.int32)
    max_len = prompt_len + gen_tokens + 1
    prefill = jax.jit(lambda p, t: ref_tfm.forward_prefill(p, t, cfg, max_len))
    decode = jax.jit(lambda p, t, c: ref_tfm.forward_decode(p, t, c, cfg))
    logits, cache = prefill(ref_params, prompts)
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    out = [tok]
    for _ in range(gen_tokens):
        logits, cache = decode(ref_params, tok, cache)
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


def test_serve_lm_on_cpu_matches_reference_loop():
    cfg, ref_params, params = _smoke()
    want = _reference_serve_tokens(ref_params, ref_danube.smoke_config(), 4, 32, 16)
    res = serve.serve_lm(cfg, 4, 32, 16, device="cpu", params=params)
    assert res.device == "cpu"
    assert res.tokens.shape == (4, 17)
    np.testing.assert_array_equal(res.tokens, want)
    assert res.logits.shape == (4, 1, cfg.vocab) and bool(torch.isfinite(res.logits).all())
    assert res.prefill_s > 0 and res.decode_s > 0 and res.tokens_per_s > 0


def test_serve_lm_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve_lm(danube.smoke_config(), 1, 4, 1)


def test_serve_cli(capsys):
    serve.main(["--device", "cpu", "--batch", "2", "--prompt", "8", "--tokens", "3"])
    assert "arch=h2o-danube-1.8b device=cpu batch=2" in capsys.readouterr().out
    serve.main(["--arch", "partition", "--device", "cpu", "--graph", "gen:grid:side=16",
                "--k", "4"])  # ported: partitions, then serves 64 batches of 4 lookups
    assert capsys.readouterr().out.startswith(
        "partition serve: driver=buffcut device=cpu n=256 k=4 ")
    serve.main(["--arch", "dlrm-mlperf", "--device", "cpu"])  # ported: serves 16 rows
    assert capsys.readouterr().out.startswith("dlrm serve: device=cpu batch=16 ")


@pytest.mark.parametrize("fn", [serve.serve_lm, tfm.init_cache, lm_common.lm_smoke_decode_state,
                                transformer_params_from_numpy],
                         ids=lambda f: f.__name__)
def test_allocating_entry_points_default_to_the_card(fn):
    import inspect

    assert inspect.signature(fn).parameters["device"].default == "cuda"
