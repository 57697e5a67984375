"""Decoder-only transformer: dense FFN, GQA, optional sliding-window
attention (counterpart of `repro/models/transformer.py`).

Parameters are a plain dict of layer-stacked tensors with a leading L axis,
under the reference's keys; a Python loop over layers takes the place of
`lax.scan`.  The reference's sharding hooks are no-ops on one device and
are left out; `scan_unroll` and `attn_unroll` only shape XLA's loops, so
they are accepted and ignored.  Mixture-of-experts layers (`n_experts > 0`)
are not ported yet and raise.

Decode writes the new token's K and V into the cache in place
(`index_copy_` at `cache_pos`), which computes what the reference's
`dynamic_update_slice` does without copying the cache; the cache passed
to `forward_decode` is the one it returns.  With a sliding window and the
default `decode_swa_mode="window_kernel"`, decode attention is the
`swa_attention_decode` kernel on a card.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels.swa_attention import swa_attention_decode
from repro_torch.models.attention import decode_attention, flash_attention, rope
from repro_torch.models.common import cross_entropy_loss, rms_norm

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}

LAYER_KEYS = ("wq", "wk", "wv", "wo", "attn_norm", "ffn_norm", "ffn_w1", "ffn_w2", "ffn_w3")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str = "lm"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab: int = 1024
    # MoE (n_experts == 0 -> dense FFN); MoE is not ported yet
    n_experts: int = 0
    top_k: int = 1
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # attention
    sliding_window: int | None = None   # SWA width (None = full attention)
    rope_theta: float = 10000.0
    # numerics
    dtype: str = "bfloat16"
    q_chunk: int = 512
    kv_chunk: int = 1024
    tie_embeddings: bool = False
    # XLA loop lowering knobs of the reference; no effect here
    scan_unroll: int = 1
    attn_unroll: bool = False
    # SWA decode: "window_kernel" = the sliding-window decode kernel;
    # "masked_full" = masked attention over the whole cache
    decode_swa_mode: str = "window_kernel"

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def param_count(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab
        attn = d * self.n_heads * self.d_head + 2 * d * self.n_kv_heads * self.d_head \
            + self.n_heads * self.d_head * d
        if self.n_experts:
            ffn = self.n_experts * 3 * d * f + d * self.n_experts
            ffn += self.n_shared_experts * 3 * d * f
        else:
            ffn = 3 * d * f
        per_layer = attn + ffn + 2 * d
        return self.n_layers * per_layer + v * d + (0 if self.tie_embeddings else v * d) + d


def _dense_only(cfg: TransformerConfig) -> None:
    if cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: mixture-of-experts layers (n_experts={cfg.n_experts}) are not "
            "ported yet; the port runs dense transformers"
        )


def init_params(gen: torch.Generator, cfg: TransformerConfig) -> dict:
    """Random weights drawn from `gen` on its device: normal / sqrt(fan_in)
    in float32, cast to the config's dtype, as the reference draws them
    (the numbers differ: JAX's PRNG is not reproduced; tests carry the
    reference's weights across with `convert.transformer_params_from_numpy`)."""
    _dense_only(cfg)
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    hd, kv = cfg.d_head, cfg.n_kv_heads
    L = cfg.n_layers
    dt = cfg.torch_dtype
    dev = gen.device

    def w(*shape, fan_in):
        x = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return (x / math.sqrt(fan_in)).to(dt)

    p = {
        "embed": w(v, d, fan_in=d),
        "final_norm": torch.ones((d,), dtype=dt, device=dev),
        "wq": w(L, d, cfg.n_heads * hd, fan_in=d),
        "wk": w(L, d, kv * hd, fan_in=d),
        "wv": w(L, d, kv * hd, fan_in=d),
        "wo": w(L, cfg.n_heads * hd, d, fan_in=cfg.n_heads * hd),
        "attn_norm": torch.ones((L, d), dtype=dt, device=dev),
        "ffn_norm": torch.ones((L, d), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = w(d, v, fan_in=d)
    p["ffn_w1"] = w(L, d, f, fan_in=d)
    p["ffn_w3"] = w(L, d, f, fan_in=d)
    p["ffn_w2"] = w(L, f, d, fan_in=f)
    return p


def dense_ffn(x: torch.Tensor, layer: dict) -> torch.Tensor:
    h = torch.nn.functional.silu(x @ layer["ffn_w1"]) * (x @ layer["ffn_w3"])
    return h @ layer["ffn_w2"]


def _layer(params: dict, i: int) -> dict:
    return {k: params[k][i] for k in LAYER_KEYS}


def _attn(x, layer, cfg: TransformerConfig, positions, k_cache=None, v_cache=None,
          cache_pos=None, mode="train"):
    b, s, d = x.shape
    hd, kv = cfg.d_head, cfg.n_kv_heads
    xq = (x @ layer["wq"]).reshape(b, s, cfg.n_heads, hd)
    xk = (x @ layer["wk"]).reshape(b, s, kv, hd)
    xv = (x @ layer["wv"]).reshape(b, s, kv, hd)
    xq = rope(xq, positions, cfg.rope_theta)
    xk = rope(xk, positions, cfg.rope_theta)

    if mode in ("train", "prefill"):
        out = flash_attention(
            xq, xk, xv, causal=True, window=cfg.sliding_window,
            q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
        )
        new_k, new_v = xk, xv
    else:  # decode: s == 1, write into the cache in place, then attend
        seq = k_cache.shape[1]
        # dynamic_update_slice clamps an out-of-range start; so does this
        slot = torch.arange(b, device=x.device) * seq + cache_pos.long().clamp(0, seq - 1)
        k_cache.view(b * seq, kv, hd).index_copy_(0, slot, xk[:, 0])
        v_cache.view(b * seq, kv, hd).index_copy_(0, slot, xv[:, 0])
        fill = cache_pos + 1
        if cfg.sliding_window is not None and cfg.decode_swa_mode == "window_kernel":
            groups = cfg.n_heads // kv
            qg = xq[:, 0].reshape(b, kv, groups, hd)
            og = swa_attention_decode(qg, k_cache, v_cache, fill, window=cfg.sliding_window)
            out = og.reshape(b, 1, cfg.n_heads, hd)
        else:
            out = decode_attention(xq, k_cache, v_cache, fill, window=cfg.sliding_window)
        new_k, new_v = k_cache, v_cache
    out = out.reshape(b, s, cfg.n_heads * hd) @ layer["wo"]
    return out, new_k, new_v


def _layer_step(x, layer, cfg: TransformerConfig, positions, mode,
                k_cache=None, v_cache=None, cache_pos=None):
    h, new_k, new_v = _attn(
        rms_norm(x, layer["attn_norm"]), layer, cfg, positions,
        k_cache, v_cache, cache_pos, mode,
    )
    x = x + h
    y = rms_norm(x, layer["ffn_norm"])
    return x + dense_ffn(y, layer), new_k, new_v


def _unembed(params: dict, cfg: TransformerConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


def forward_train(params: dict, tokens: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V) float32 (forward only)."""
    _dense_only(cfg)
    b, s = tokens.shape
    x = params["embed"][tokens.long()].to(cfg.torch_dtype)
    positions = torch.arange(s, device=x.device).expand(b, s)
    for i in range(cfg.n_layers):
        x, _, _ = _layer_step(x, _layer(params, i), cfg, positions, "train")
    x = rms_norm(x, params["final_norm"])
    return (x @ _unembed(params, cfg)).float()


def loss_fn(params: dict, batch: dict, cfg: TransformerConfig) -> torch.Tensor:
    logits = forward_train(params, batch["tokens"], cfg)
    return cross_entropy_loss(logits, batch["labels"], batch.get("mask"))


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device: str | torch.device = "cuda") -> dict:
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {
        "k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def forward_prefill(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
                    max_len: int) -> tuple[torch.Tensor, dict]:
    """Prefill: run the full prompt, return last-token logits (B, 1, V) and
    the KV cache, allocated at `max_len` and filled up to the prompt."""
    _dense_only(cfg)
    b, s = tokens.shape
    if max_len < s:
        raise ValueError(f"max_len {max_len} is shorter than the prompt ({s} tokens)")
    x = params["embed"][tokens.long()].to(cfg.torch_dtype)
    positions = torch.arange(s, device=x.device).expand(b, s)
    cache = init_cache(cfg, b, max_len, device=x.device)
    for i in range(cfg.n_layers):
        x, new_k, new_v = _layer_step(x, _layer(params, i), cfg, positions, "prefill")
        cache["k"][i, :, :s] = new_k
        cache["v"][i, :, :s] = new_v
    x = rms_norm(x, params["final_norm"])
    logits = (x[:, -1:] @ _unembed(params, cfg)).float()
    cache["pos"].fill_(s)
    return logits, cache


def forward_decode(params: dict, tokens: torch.Tensor, cache: dict,
                   cfg: TransformerConfig) -> tuple[torch.Tensor, dict]:
    """One decode step. tokens (B, 1); cache from `init_cache` or
    `forward_prefill`, updated in place (its `pos` is replaced)."""
    _dense_only(cfg)
    x = params["embed"][tokens.long()].to(cfg.torch_dtype)
    pos = cache["pos"]
    positions = pos[:, None]
    for i in range(cfg.n_layers):
        x, _, _ = _layer_step(x, _layer(params, i), cfg, positions, "decode",
                              cache["k"][i], cache["v"][i], pos)
    x = rms_norm(x, params["final_norm"])
    logits = (x @ _unembed(params, cfg)).float()
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
