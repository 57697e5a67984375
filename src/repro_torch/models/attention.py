"""Attention layers: GQA causal / sliding-window, chunked flash-style
(counterpart of `repro/models/attention.py`).

`flash_attention` is the reference's double-chunked online-softmax
formulation in plain torch: the same q and kv chunking, the same masks and
the same float32 online softmax.  Operands are widened to float32 before
each product, as the reference's `preferred_element_type=float32` does,
so bf16 scores are never rounded to bf16; keep TF32 off
(`torch.backends.cuda.matmul.allow_tf32`, False by default) on this path.
The reference also computes the kv chunks that the causal window masks
out entirely, and so does this port.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, D); positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].float() * freq  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    q_offset: int = 0,
) -> torch.Tensor:
    """q (B, Sq, H, D); k/v (B, Skv, KVH, D) with H % KVH == 0.

    The G query heads of a group contract against their shared KV chunk;
    KV heads are never repeated per query head.  window: sliding-window
    size (None = full).  q_offset: absolute position of q[0] relative to
    k[0] (prefill continuation).
    """
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    dev = q.device
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32, device=dev))
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    n_q = -(-sq // q_chunk)
    n_kv = -(-skv // kv_chunk)
    q_pad = n_q * q_chunk - sq
    kv_pad = n_kv * kv_chunk - skv
    if q_pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, q_pad))
    if kv_pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, kv_pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, kv_pad))

    # (B, KVH, G, S, D) queries; (B, KVH, S, D) keys and values, in float32
    qq = q.reshape(b, n_q * q_chunk, kvh, g, d).permute(0, 2, 3, 1, 4).float()
    kq = k.permute(0, 2, 1, 3).float()
    vq = v.permute(0, 2, 1, 3).float()

    out = torch.empty((b, kvh, g, n_q * q_chunk, d), dtype=torch.float32, device=dev)
    for qi in range(n_q):
        qc = qq[:, :, :, qi * q_chunk:(qi + 1) * q_chunk]  # (B, KVH, G, Qc, D)
        q_pos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((b, kvh, g, q_chunk), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, kvh, g, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kvh, g, q_chunk, d), dtype=torch.float32, device=dev)
        for ki in range(n_kv):
            kc = kq[:, :, ki * kv_chunk:(ki + 1) * kv_chunk]  # (B, KVH, Kc, D)
            vc = vq[:, :, ki * kv_chunk:(ki + 1) * kv_chunk]
            kpos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qc, kc) * scale
            mask = (kpos[None, :] < skv).expand(q_chunk, kv_chunk)  # drop kv padding
            if causal:
                mask = mask & (q_pos[:, None] >= kpos[None, :])
            if window is not None:
                mask = mask & (kpos[None, :] > q_pos[:, None] - window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            p = torch.where(mask, p, 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p, vc)
            m = m_new
        out[:, :, :, qi * q_chunk:(qi + 1) * q_chunk] = acc / l.clamp(min=1e-30)[..., None]
    out = out.reshape(b, kvh * g, n_q * q_chunk, d).permute(0, 2, 1, 3)[:, :sq]
    return out.to(q.dtype)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos: torch.Tensor,
    window: int | None = None,
) -> torch.Tensor:
    """One-token decode against the full cache. q (B, 1, H, D); cache
    (B, S, KVH, D); pos (B,) = current fill level (attends to
    [max(0, pos - window), pos)).  The reference's `masked_full` SWA decode
    mode."""
    b, s, kvh, d = k_cache.shape
    h = q.shape[2]
    groups = h // kvh
    qg = q[:, 0].reshape(b, kvh, groups, d).float()
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32, device=q.device))
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * scale
    positions = torch.arange(s, device=q.device)[None, :]
    valid = positions < pos[:, None]  # (B, S)
    if window is not None:
        valid = valid & (positions >= (pos[:, None] - window))
    mask = valid[:, None, None, :]
    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(scores - m), 0.0)
    probs = e / e.sum(-1, keepdim=True).clamp(min=1e-30)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)
