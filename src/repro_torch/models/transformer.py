"""Decoder-only transformer: dense or mixture-of-experts FFN, GQA,
optional sliding-window attention (counterpart of
`repro/models/transformer.py`).

Parameters are a plain dict of layer-stacked tensors with a leading L axis,
under the reference's keys; a Python loop over layers takes the place of
`lax.scan`, and with autograd on, `forward_train` recomputes each layer in
the backward (`torch.utils.checkpoint`, the reference's per-layer
`jax.checkpoint` with nothing saveable).  `scan_unroll` and `attn_unroll`
only shape XLA's loops, so they are accepted and ignored.

On a device mesh the same functions run on DTensors placed by
`distributed/sharding.py`, and the reference's three hooks keep their
names: `set_activation_sharding` and `set_attn_sharding` install
functions that redistribute the activations and q/k/v (the reference's
`with_sharding_constraint`s), and `set_moe_spmd` switches the MoE layer to
its expert-parallel form, `_moe_ffn_spmd`.  Attention, the decode cache
write and the MoE dispatch run in local regions (`distributed/spmd.py`):
the sliding-window kernel and `flash_attention` see plain local tensors.
With plain tensors and no hook set, nothing of this runs.

The MoE layer is the reference's: top-k routing, a capacity rank by an
exclusive cumsum over tokens, a pack into one (E, cap, d) buffer, batched
expert SwiGLU products, and a weighted combine.  Its top k come from a
stable descending sort, so equal router probabilities pick the lower
expert first, as `jax.lax.top_k` does; the combine adds each token's k
contributions in k order, with no float atomics, so a rerun on a card
gives the same bits.  Expert-parallel, each shard sizes its capacity from
its own tokens (`cap_loc`), as the reference's `shard_map` body does, so
its result can differ from the one-device layer wherever that drops
tokens.

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
from torch.distributed.tensor import Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import spmd
from repro_torch.kernels.swa_attention import swa_attention_decode
from repro_torch.models.attention import decode_attention, flash_attention, rope
from repro_torch.models.common import cross_entropy_loss, rms_norm

_mm = spmd.matmul

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}

# the layer-stacked keys (the reference's `_split_layers`); a config has
# the dense FFN's or the MoE's, and the shared experts' only with them
LAYER_KEYS = (
    "wq", "wk", "wv", "wo", "attn_norm", "ffn_norm",
    "router", "moe_w1", "moe_w2", "moe_w3",
    "shared_w1", "shared_w2", "shared_w3",
    "ffn_w1", "ffn_w2", "ffn_w3",
)


# Sharding hooks (None = no constraint).  The launcher installs them around
# a mesh step (`launch/steps.py`) and clears them after.
_ACT_SHARD = None
_ATTN_SHARD = None  # fn(tensor, role) with role in {"q", "k", "v"}
_MOE_SPMD = None    # {"mesh": DeviceMesh, "x_spec": spec tuple, "expert_axis": str}
_REMAT = True       # recompute each layer in the backward (off only to count its cost)


def set_remat(flag: bool) -> None:
    """Turn the per-layer recompute of `forward_train` on or off (the step
    analysis counts the flops it adds: `launch/step_analysis.py::
    remat_duplication`)."""
    global _REMAT
    _REMAT = bool(flag)


def set_activation_sharding(fn) -> None:
    """Install fn(x) on the (B, S, d) activations between blocks (sequence
    parallelism); None removes it."""
    global _ACT_SHARD
    _ACT_SHARD = fn


def set_attn_sharding(fn) -> None:
    """Install fn(x, role) on post-RoPE q/k/v (B, S, H, D): the launcher
    pins q sequence-sharded over 'model' and k/v batch-sharded only."""
    global _ATTN_SHARD
    _ATTN_SHARD = fn


def _shard_act(x):
    return _ACT_SHARD(x) if _ACT_SHARD is not None else x


def _shard_attn(x, role):
    return _ATTN_SHARD(x, role) if _ATTN_SHARD is not None else x


def set_moe_spmd(mesh=None, x_spec=None, expert_axis="model") -> None:
    """Install the expert-parallel layout for MoE layers: each rank packs
    its local tokens into per-expert capacity buffers, an all-to-all over
    `expert_axis` moves them to the experts' owners, the expert products
    run locally, and the reverse all-to-all brings them home.  `x_spec` is
    the spec (`distributed/sharding.py`) of the (B, S, d) activations
    entering the layer, e.g. (("data",), "model", None) under sequence
    parallelism.  `mesh=None` removes it."""
    global _MOE_SPMD
    _MOE_SPMD = None if mesh is None else {"mesh": mesh, "x_spec": tuple(x_spec),
                                           "expert_axis": expert_axis}


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


def _moe_spmd_layout(x_shape, cfg: TransformerConfig):
    """(mesh, activation placements, expert mesh dim, tokens a shard, cap_loc)."""
    from repro_torch.distributed.sharding import MeshSharding

    mesh = _MOE_SPMD["mesh"]
    spec = _MOE_SPMD["x_spec"]
    x_pl = MeshSharding(mesh, spec).placements()
    names = mesh.mesh_dim_names
    n_tok_shards = 1
    for entry in spec[:2]:
        for a in (entry if isinstance(entry, tuple) else ((entry,) if entry else ())):
            n_tok_shards *= mesh.size(names.index(a))
    b, s_len, _ = x_shape
    t_loc = max(b * s_len // n_tok_shards, 1)
    cap_loc = _moe_cap(t_loc, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    return mesh, x_pl, names.index(_MOE_SPMD["expert_axis"]), t_loc, cap_loc


def _moe_ffn_spmd(x3, layer: dict, cfg: TransformerConfig):
    """Expert-parallel MoE (see `set_moe_spmd`): a local region over the
    (B, S, d) activations, a DTensor.  Tokens are flattened locally, each
    rank dispatches its own with `cap_loc` from its local token count, an
    all-to-all over the expert axis ships (E, cap, d) buffers to the
    experts' owners as (E/tp, tp*cap, d), the expert products run on the
    local experts, the reverse all-to-all brings the outputs home, and the
    combine is local."""
    mesh, x_pl, ea, _, cap_loc = _moe_spmd_layout(x3.shape, cfg)
    e, k = cfg.n_experts, cfg.top_k
    d = x3.shape[2]
    tp = mesh.size(ea)
    split = spmd.split_mesh_dims(x_pl)
    repl = spmd.replicated(mesh.ndim)
    expert_pl = tuple(Shard(0) if i == ea else Replicate() for i in range(mesh.ndim))
    x_loc3 = spmd.local_in(x3, x_pl)
    router = spmd.local_in(layer["router"], repl, split)
    w1, w3, w2 = (spmd.local_in(layer[n], expert_pl, split)
                  for n in ("moe_w1", "moe_w3", "moe_w2"))
    group = mesh.get_group(ea)
    bl, sl, _ = x_loc3.shape
    x_loc = x_loc3.reshape(bl * sl, d)               # LOCAL flatten: no resharding
    tl = x_loc.shape[0]
    fs, ft, fw, keep = _moe_dispatch(x_loc, router, e, k, cap_loc)
    buf = _moe_pack(x_loc, fs, ft, keep, e, cap_loc)
    # to the experts' owners: (E, cap, d) -> (E/tp, tp*cap, d)
    buf = spmd.all_to_all(buf, group)                # (tp, E/tp, cap, d) by source rank
    buf = buf.reshape(tp, e // tp, cap_loc, d).transpose(0, 1).reshape(e // tp, tp * cap_loc, d)
    out = _moe_expert_mlp(buf, w1, w3, w2)
    # home: (E/tp, tp*cap, d) -> (E, cap, d)
    out = out.reshape(e // tp, tp, cap_loc, d).transpose(0, 1).reshape(e, cap_loc, d)
    out = spmd.all_to_all(out, group)
    y = _moe_combine(out.reshape(e * cap_loc, d), fs, ft, fw, tl, d, e, cap_loc, x_loc.dtype)
    return spmd.local_out(y.reshape(bl, sl, d), mesh, x_pl, x3.shape)


def moe_ffn(x3: torch.Tensor, layer: dict, cfg: TransformerConfig) -> torch.Tensor:
    """Capacity-factor top-k MoE plus the shared experts.  x3: (B, S, d).
    The capacity depends on B·S, so a decode step (B tokens) can drop other
    tokens than `forward_train` does at the same position, as in the
    reference.  With `set_moe_spmd` active the dispatch runs
    expert-parallel (`_moe_ffn_spmd`, on DTensors)."""
    b, s_len, d = x3.shape
    e, k = cfg.n_experts, cfg.top_k
    if _MOE_SPMD is not None:
        out = _moe_ffn_spmd(x3, layer, cfg)
    else:
        x = x3.reshape(b * s_len, d)
        t = x.shape[0]
        cap = _moe_cap(t, k, e, cfg.capacity_factor)
        fs, ft, fw, keep = _moe_dispatch(x, layer["router"], e, k, cap)
        buf = _moe_pack(x, fs, ft, keep, e, cap)
        out_buf = _moe_expert_mlp(buf, layer["moe_w1"], layer["moe_w3"], layer["moe_w2"])
        out = _moe_combine(out_buf.reshape(e * cap, d), fs, ft, fw, t, d, e, cap,
                           x.dtype).reshape(b, s_len, d)
    if cfg.n_shared_experts:
        hs = F.silu(_mm(x3, layer["shared_w1"])) * _mm(x3, layer["shared_w3"])
        out = out + _mm(hs, layer["shared_w2"])
    return out


def dense_ffn(x: torch.Tensor, layer: dict) -> torch.Tensor:
    h = F.silu(_mm(x, layer["ffn_w1"])) * _mm(x, layer["ffn_w3"])
    return _mm(h, layer["ffn_w2"])


def _layers(params: dict) -> list[dict]:
    """Each layer's slices of the stacked tensors.  One `unbind` a tensor,
    so under autograd the backward stacks the layers' gradients once;
    indexing a layer at a time would give each layer's gradient as a
    zero-filled full stack, L times the stacked bytes."""
    keys = [k for k in LAYER_KEYS if k in params]
    return [dict(zip(keys, slices)) for slices in zip(*(params[k].unbind(0) for k in keys))]


def _flash_local(xq, xk, xv, cfg: TransformerConfig):
    """`flash_attention` in a local region over DTensor q/k/v (B, S, H, D).
    q keeps its layout; k/v follow q's batch split, are gathered over a
    sequence split, and over a head split of q either follow it (when kv
    heads are split too) or are indexed to the local q heads' kv heads.
    A sequence-split q attends from its global offset."""
    mesh = xq.device_mesh
    q_pl = tuple(xq.placements)
    kv_pl = []
    for qp, kp in zip(q_pl, xk.placements):
        if qp == Shard(0) or (qp == Shard(2) and kp == Shard(2)):
            kv_pl.append(qp)
        else:
            kv_pl.append(Replicate())
    split = spmd.split_mesh_dims(q_pl)
    off = spmd.global_offset(xq)
    q = spmd.local_in(xq, q_pl)
    k = spmd.local_in(xk, kv_pl, split)
    v = spmd.local_in(xv, kv_pl, split)
    h_loc, kvh_loc = q.shape[2], k.shape[2]
    if h_loc % kvh_loc or (h_loc // kvh_loc) != cfg.n_heads // cfg.n_kv_heads:
        # q's heads split, kv's not: each local q head reads its kv head
        groups = cfg.n_heads // cfg.n_kv_heads
        kv_idx = (off[2] + torch.arange(h_loc, device=q.device)) // groups
        k, v = k.index_select(2, kv_idx), v.index_select(2, kv_idx)
    out = flash_attention(
        q, k, v, causal=True, window=cfg.sliding_window,
        q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk, q_offset=off[1],
    )
    return spmd.local_out(out, mesh, q_pl, xq.shape)


def _decode_local(xq, xk, xv, k_cache, v_cache, cache_pos, cfg: TransformerConfig):
    """Decode's cache write and attention in a local region over DTensors:
    q/k/v (B, 1, H, D), one layer's cache (B, S, KV, D), cache_pos (B,).
    Each rank writes the token into its own block of the cache where the
    position falls in it, then attends over the cache gathered along the
    sequence (the sliding-window kernel on the local batch)."""
    mesh = k_cache.device_mesh
    c_pl = tuple(k_cache.placements)
    rows_pl = tuple(p if p == Shard(0) else Replicate() for p in c_pl)
    q = spmd.local_in(xq, rows_pl)
    k_new = spmd.local_in(xk, rows_pl)
    v_new = spmd.local_in(xv, rows_pl)
    pos = spmd.local_in(cache_pos, rows_pl)
    seq = k_cache.shape[1]
    s_off = spmd.global_offset(k_cache)[1]
    kc, vc = k_cache.to_local(), v_cache.to_local()
    b, s_loc, kv, hd = kc.shape
    # dynamic_update_slice clamps an out-of-range start; so does this
    p_loc = pos.long().clamp(0, seq - 1) - s_off
    mine = ((p_loc >= 0) & (p_loc < s_loc))[:, None, None]
    slot = torch.arange(b, device=kc.device) * s_loc + p_loc.clamp(0, s_loc - 1)
    for cache, new in ((kc, k_new), (vc, v_new)):
        flat = cache.view(b * s_loc, kv, hd)
        flat.index_copy_(0, slot, torch.where(mine, new[:, 0], flat[slot]))
    k_full = spmd.with_placements(k_cache, rows_pl).to_local()
    v_full = spmd.with_placements(v_cache, rows_pl).to_local()
    out = _decode_attend(q, k_full, v_full, pos + 1, cfg)
    return spmd.local_out(out, mesh, rows_pl, xq.shape)


def _decode_attend(xq, k_cache, v_cache, fill, cfg: TransformerConfig):
    b = xq.shape[0]
    hd, kv = cfg.d_head, cfg.n_kv_heads
    if cfg.sliding_window is not None and cfg.decode_swa_mode == "window_kernel":
        groups = cfg.n_heads // kv
        qg = xq[:, 0].reshape(b, kv, groups, hd)
        og = swa_attention_decode(qg, k_cache, v_cache, fill, window=cfg.sliding_window)
        return og.reshape(b, 1, cfg.n_heads, hd)
    return decode_attention(xq, k_cache, v_cache, fill, window=cfg.sliding_window)


def _attn(x, layer, cfg: TransformerConfig, positions, k_cache=None, v_cache=None,
          cache_pos=None, mode="train"):
    b, s, d = x.shape
    hd, kv = cfg.d_head, cfg.n_kv_heads
    xq = _mm(x, layer["wq"]).reshape(b, s, cfg.n_heads, hd)
    xk = _mm(x, layer["wk"]).reshape(b, s, kv, hd)
    xv = _mm(x, layer["wv"]).reshape(b, s, kv, hd)
    xq = rope(xq, positions, cfg.rope_theta)
    xk = rope(xk, positions, cfg.rope_theta)

    if mode in ("train", "prefill"):
        xq = _shard_attn(xq, "q")
        xk = _shard_attn(xk, "k")
        xv = _shard_attn(xv, "v")
        if spmd.is_dtensor(xq):
            out = _flash_local(xq, xk, xv, cfg)
        else:
            out = flash_attention(
                xq, xk, xv, causal=True, window=cfg.sliding_window,
                q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
            )
        new_k, new_v = xk, xv
    elif spmd.is_dtensor(k_cache):  # decode on a mesh
        out = _decode_local(xq, xk, xv, k_cache, v_cache, cache_pos, cfg)
        new_k, new_v = k_cache, v_cache
    else:  # decode: s == 1, write into the cache in place, then attend
        seq = k_cache.shape[1]
        # dynamic_update_slice clamps an out-of-range start; so does this
        slot = torch.arange(b, device=x.device) * seq + cache_pos.long().clamp(0, seq - 1)
        k_cache.view(b * seq, kv, hd).index_copy_(0, slot, xk[:, 0])
        v_cache.view(b * seq, kv, hd).index_copy_(0, slot, xv[:, 0])
        out = _decode_attend(xq, k_cache, v_cache, cache_pos + 1, cfg)
        new_k, new_v = k_cache, v_cache
    out = _mm(out.reshape(b, s, cfg.n_heads * hd), layer["wo"])
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
    x = _shard_act(spmd.embedding(params["embed"], tokens).to(cfg.torch_dtype))
    positions = torch.arange(s, device=x.device).expand(b, s)

    def body(x, layer):
        return _shard_act(_layer_step(x, layer, cfg, positions, "train")[0])

    for layer in _layers(params):
        if torch.is_grad_enabled() and _REMAT:
            # the layer draws no random numbers, so there is no RNG state to keep
            x = checkpoint(body, x, layer, use_reentrant=False, preserve_rng_state=False)
        else:
            x = body(x, layer)
    x = rms_norm(x, params["final_norm"])
    return _mm(x, _unembed(params, cfg)).float()


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
    x = spmd.embedding(params["embed"], tokens).to(cfg.torch_dtype)
    positions = torch.arange(s, device=x.device).expand(b, s)
    if spmd.is_dtensor(x):
        # on a mesh the cache is assembled from the layers' K/V, as the
        # reference stacks its scan's outputs and pads them
        ks, vs = [], []
        for layer in _layers(params):
            x, new_k, new_v = _layer_step(x, layer, cfg, positions, "prefill")
            ks.append(new_k)
            vs.append(new_v)
        pad = (0, 0, 0, 0, 0, max_len - s)
        cache = {"k": F.pad(torch.stack(ks), pad), "v": F.pad(torch.stack(vs), pad),
                 "pos": torch.full((b,), s, dtype=torch.int32, device=x.device)}
    else:
        cache = init_cache(cfg, b, max_len, device=x.device)
        for i, layer in enumerate(_layers(params)):
            x, new_k, new_v = _layer_step(x, layer, cfg, positions, "prefill")
            cache["k"][i, :, :s] = new_k
            cache["v"][i, :, :s] = new_v
        cache["pos"].fill_(s)
    x = rms_norm(x, params["final_norm"])
    logits = _mm(x[:, -1:], _unembed(params, cfg)).float()
    return logits, cache


def forward_decode(params: dict, tokens: torch.Tensor, cache: dict,
                   cfg: TransformerConfig) -> tuple[torch.Tensor, dict]:
    """One decode step. tokens (B, 1); cache from `init_cache` or
    `forward_prefill`, updated in place (its `pos` is replaced)."""
    x = spmd.embedding(params["embed"], tokens).to(cfg.torch_dtype)
    pos = cache["pos"]
    positions = pos[:, None]
    for i, layer in enumerate(_layers(params)):
        x, _, _ = _layer_step(x, layer, cfg, positions, "decode",
                              cache["k"][i], cache["v"][i], pos)
    x = rms_norm(x, params["final_norm"])
    logits = _mm(x, _unembed(params, cfg)).float()
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
