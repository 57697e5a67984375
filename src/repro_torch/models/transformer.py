"""Decoder-only transformer: dense or mixture-of-experts FFN, GQA,
optional sliding-window attention (counterpart of
`repro/models/transformer.py`).

Parameters are a plain dict of layer-stacked tensors with a leading L axis,
under the reference's keys; a Python loop over layers takes the place of
`lax.scan`, and with autograd on, `forward_train` recomputes each layer in
the backward (`torch.utils.checkpoint`, the reference's per-layer
`jax.checkpoint` with nothing saveable).  The reference's sharding hooks
and its expert-parallel MoE (`set_moe_spmd`, a `shard_map` over a mesh)
are left out: on one device they are no-ops.  `scan_unroll` and
`attn_unroll` only shape XLA's loops, so they are accepted and ignored.

The MoE layer is the reference's single-device path: top-k routing, a
capacity rank by an exclusive cumsum over tokens, a pack into one
(E, cap, d) buffer, batched expert SwiGLU products, and a weighted
combine.  Its top k come from a stable descending sort, so equal router
probabilities pick the lower expert first, as `jax.lax.top_k` does; the
combine adds each token's k contributions in k order, with no float
atomics, so a rerun on a card gives the same bits.

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
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.swa_attention import swa_attention_decode
from repro_torch.models.attention import decode_attention, flash_attention, rope
from repro_torch.models.common import cross_entropy_loss, rms_norm

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}

# the layer-stacked keys (the reference's `_split_layers`); a config has
# the dense FFN's or the MoE's, and the shared experts' only with them
LAYER_KEYS = (
    "wq", "wk", "wv", "wo", "attn_norm", "ffn_norm",
    "router", "moe_w1", "moe_w2", "moe_w3",
    "shared_w1", "shared_w2", "shared_w3",
    "ffn_w1", "ffn_w2", "ffn_w3",
)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str = "lm"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab: int = 1024
    # MoE (n_experts == 0 -> dense FFN)
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

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if not self.n_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        all_experts = self.n_layers * self.n_experts * 3 * d * f
        active = self.n_layers * self.top_k * 3 * d * f
        return self.param_count() - all_experts + active


# float32 elements drawn at a time by `init_params` (1 GiB)
_DRAW_CHUNK = 1 << 28


def init_params(gen: torch.Generator, cfg: TransformerConfig) -> dict:
    """Random weights drawn from `gen` on its device: normal / sqrt(fan_in)
    in float32, cast to the config's dtype, as the reference draws them
    (the numbers differ: JAX's PRNG is not reproduced; tests carry the
    reference's weights across with `convert.transformer_params_from_numpy`).
    Each tensor is allocated in the config's dtype and filled a block of
    rows at a time, so the float32 draw never exists whole: moonshot's
    `moe_w1` alone would be a 35.4 GB float32 temporary."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    hd, kv = cfg.d_head, cfg.n_kv_heads
    L = cfg.n_layers
    dt = cfg.torch_dtype
    dev = gen.device

    def w(*shape, fan_in):
        out = torch.empty(shape, dtype=dt, device=dev)
        rows = out.view(-1, shape[-1])
        for block in rows.split(max(1, _DRAW_CHUNK // shape[-1])):
            x = torch.randn(block.shape, generator=gen, dtype=torch.float32, device=dev)
            block.copy_(x.div_(math.sqrt(fan_in)))
        return out

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
    if cfg.n_experts:
        e = cfg.n_experts
        p["router"] = w(L, d, e, fan_in=d)
        p["moe_w1"] = w(L, e, d, f, fan_in=d)
        p["moe_w3"] = w(L, e, d, f, fan_in=d)
        p["moe_w2"] = w(L, e, f, d, fan_in=f)
        if cfg.n_shared_experts:
            fs = cfg.n_shared_experts * f
            p["shared_w1"] = w(L, d, fs, fan_in=d)
            p["shared_w3"] = w(L, d, fs, fan_in=d)
            p["shared_w2"] = w(L, fs, d, fan_in=fs)
    else:
        p["ffn_w1"] = w(L, d, f, fan_in=d)
        p["ffn_w3"] = w(L, d, f, fan_in=d)
        p["ffn_w2"] = w(L, f, d, fan_in=f)
    return p


# ---------------------------------------------------------------- MoE FFN

def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`jax.lax.top_k`: the k largest in descending order, equal values
    lower index first (a stable sort; `torch.topk` promises no tie order
    on a card)."""
    top_i = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :k]
    return probs.gather(1, top_i), top_i


def _moe_dispatch(x: torch.Tensor, router: torch.Tensor, e: int, k: int, cap: int):
    """Top-k routing and the capacity rank of each (token, choice): the
    number of earlier tokens routed to the same expert, an exclusive cumsum
    over the (T, E) one-hot.  Returns (flat_slot, flat_t, flat_w, keep):
    slot `expert·cap + rank`, or the trash slot `e·cap` where the expert is
    full; the token of each entry; its weight (0 where dropped); keep (T, k)."""
    t = x.shape[0]
    logits = (x @ router).float()                                   # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = _top_k(probs, k)                                 # (T, k)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    experts = torch.arange(e, device=x.device)
    assign = (top_i[:, :, None] == experts).sum(dim=1)              # (T, E) one-hot sum
    before = assign.cumsum(dim=0) - assign                          # exclusive
    rank = before.gather(1, top_i)                                  # (T, k)
    keep = rank < cap
    slot = torch.where(keep, top_i * cap + rank.clamp(max=cap - 1), e * cap)
    flat_t = torch.arange(t * k, device=x.device) // k              # repeat(arange(t), k)
    return slot.reshape(-1), flat_t, (top_p * keep).reshape(-1), keep


def _moe_pack(x: torch.Tensor, flat_slot, flat_t, keep, e: int, cap: int) -> torch.Tensor:
    """(E, cap, d) expert buffers: each kept entry's token row at its slot.
    Kept slots are unique; every dropped entry writes the trash row e·cap,
    which is cut off (so which of them lands there does not matter)."""
    d = x.shape[1]
    rows = x[flat_t] * keep.reshape(-1, 1).to(x.dtype)
    buf = x.new_zeros((e * cap + 1, d)).index_copy(0, flat_slot, rows)
    return buf[: e * cap].reshape(e, cap, d)


def _moe_expert_mlp(buf: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                    w2: torch.Tensor) -> torch.Tensor:
    h = F.silu(torch.bmm(buf, w1)) * torch.bmm(buf, w3)
    return torch.bmm(h, w2)


def _moe_combine(out_buf_flat: torch.Tensor, flat_slot, flat_t, flat_w, t: int, d: int,
                 e: int, cap: int, dtype: torch.dtype) -> torch.Tensor:
    """out[t] = Σ_j w[t, j] · out_buf[slot[t, j]], summed in j order from
    zero (the reference's scatter-add over `flat_t = repeat(arange(t), k)`);
    a dropped entry reads row e·cap − 1 with weight 0.  k ordered adds, not
    `index_add_`, whose float atomics on a card would make the sum's order,
    and so greedy decode, vary from run to run."""
    k = flat_slot.shape[0] // t
    contrib = out_buf_flat[flat_slot.clamp(max=e * cap - 1)] * flat_w[:, None].to(dtype)
    contrib = contrib.reshape(t, k, d)
    out = torch.zeros((t, d), dtype=dtype, device=out_buf_flat.device)
    for j in range(k):
        out = out + contrib[:, j]
    return out


def _moe_cap(t: int, k: int, e: int, cf: float) -> int:
    cap = int(cf * t * k / e) + 1
    return min(max(((cap + 3) // 4) * 4, 4), t * k)


def moe_ffn(x3: torch.Tensor, layer: dict, cfg: TransformerConfig) -> torch.Tensor:
    """Capacity-factor top-k MoE on one device, plus the shared experts.
    x3: (B, S, d).  The capacity depends on B·S, so a decode step (B
    tokens) can drop other tokens than `forward_train` does at the same
    position, as in the reference."""
    b, s_len, d = x3.shape
    e, k = cfg.n_experts, cfg.top_k
    x = x3.reshape(b * s_len, d)
    t = x.shape[0]
    cap = _moe_cap(t, k, e, cfg.capacity_factor)
    fs, ft, fw, keep = _moe_dispatch(x, layer["router"], e, k, cap)
    buf = _moe_pack(x, fs, ft, keep, e, cap)
    out_buf = _moe_expert_mlp(buf, layer["moe_w1"], layer["moe_w3"], layer["moe_w2"])
    out = _moe_combine(out_buf.reshape(e * cap, d), fs, ft, fw, t, d, e, cap,
                       x.dtype).reshape(b, s_len, d)
    if cfg.n_shared_experts:
        hs = F.silu(x3 @ layer["shared_w1"]) * (x3 @ layer["shared_w3"])
        out = out + hs @ layer["shared_w2"]
    return out


def dense_ffn(x: torch.Tensor, layer: dict) -> torch.Tensor:
    h = F.silu(x @ layer["ffn_w1"]) * (x @ layer["ffn_w3"])
    return h @ layer["ffn_w2"]


def _layers(params: dict) -> list[dict]:
    """Each layer's slices of the stacked tensors.  One `unbind` a tensor,
    so under autograd the backward stacks the layers' gradients once;
    indexing a layer at a time would give each layer's gradient as a
    zero-filled full stack, L times the stacked bytes."""
    keys = [k for k in LAYER_KEYS if k in params]
    return [dict(zip(keys, slices)) for slices in zip(*(params[k].unbind(0) for k in keys))]


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
    f = moe_ffn(y, layer, cfg) if cfg.n_experts else dense_ffn(y, layer)
    return x + f, new_k, new_v


def _unembed(params: dict, cfg: TransformerConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


def forward_train(params: dict, tokens: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V) float32.  With grad mode on, each
    layer keeps only its input for the backward and recomputes the rest."""
    b, s = tokens.shape
    x = params["embed"][tokens.long()].to(cfg.torch_dtype)
    positions = torch.arange(s, device=x.device).expand(b, s)

    def body(x, layer):
        return _layer_step(x, layer, cfg, positions, "train")[0]

    for layer in _layers(params):
        if torch.is_grad_enabled():
            # the layer draws no random numbers, so there is no RNG state to keep
            x = checkpoint(body, x, layer, use_reentrant=False, preserve_rng_state=False)
        else:
            x = body(x, layer)
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
    b, s = tokens.shape
    if max_len < s:
        raise ValueError(f"max_len {max_len} is shorter than the prompt ({s} tokens)")
    x = params["embed"][tokens.long()].to(cfg.torch_dtype)
    positions = torch.arange(s, device=x.device).expand(b, s)
    cache = init_cache(cfg, b, max_len, device=x.device)
    for i, layer in enumerate(_layers(params)):
        x, new_k, new_v = _layer_step(x, layer, cfg, positions, "prefill")
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
    x = params["embed"][tokens.long()].to(cfg.torch_dtype)
    pos = cache["pos"]
    positions = pos[:, None]
    for i, layer in enumerate(_layers(params)):
        x, _, _ = _layer_step(x, layer, cfg, positions, "decode",
                              cache["k"][i], cache["v"][i], pos)
    x = rms_norm(x, params["final_norm"])
    logits = (x @ _unembed(params, cfg)).float()
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
