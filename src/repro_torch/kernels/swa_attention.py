"""Sliding-window GQA decode attention: the CUDA kernel, its wrapper and its plain version.

One new token per batch row attends to the cache positions
`[max(0, pos - window), min(pos, S))`, with the G query heads of a KV head
processed together:

    q (B, KVH, G, D); k_cache, v_cache (B, S, KVH, D); pos (B,) int32
    -> out (B, KVH, G, D) in q's dtype

Replaces `repro/kernels/swa_attention.py::_swa_kernel` and what its wrapper
`repro/kernels/ops.py::swa_attention_decode` does around it (oracle
`repro/kernels/ref.py::swa_attention_decode_ref`).  The reference slices an
aligned window of the cache and pads D to 128 lanes before the kernel; the
kernel here, `csrc/swa_attention.cu`, reads the window's rows straight from
the cache, pads nothing, and is bound by the bytes of K and V it reads.  Its
numerics are the Pallas kernel's: float32 products and sums, the scale
`1 / sqrt(D)` as a Python float, an exact softmax whose denominator is
floored at 1e-30 (an empty window gives zeros), the output cast to q's
dtype.

`swa_attention_decode` has the reference wrapper's signature without its
`use_kernel` and `interpret` switches: it takes the plain version only for
tensors on the CPU, and for CUDA tensors it launches the kernel or raises.
`launches` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ERR_SHARED_MEMORY = -1
_MAX_GROUPS = 16


def swa_attention_decode_plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                               pos: torch.Tensor, *, window: int) -> torch.Tensor:
    """Plain PyTorch version: gathers each row's window of the cache and
    computes the kernel's float32 arithmetic on it."""
    b, s, kvh, d = k_cache.shape
    span = min(int(window), s)
    if span == 0:
        return torch.zeros_like(q)
    pos = pos.to(torch.int64)
    lo = (pos - window).clamp(min=0)
    hi = pos.clamp(max=s)
    idx = lo[:, None] + torch.arange(span, device=q.device)  # (B, span)
    valid = idx < hi[:, None]
    rows = torch.arange(b, device=q.device)[:, None]
    kw = k_cache[rows, idx.clamp(max=s - 1)].float()  # (B, span, KVH, D)
    vw = v_cache[rows, idx.clamp(max=s - 1)].float()
    scale = 1.0 / float(d) ** 0.5
    scores = torch.einsum("bhgd,bwhd->bhgw", q.float(), kw) * scale
    mask = valid[:, None, None, :]
    scores = torch.where(mask, scores, _NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(scores - m), 0.0)
    probs = e / e.sum(-1, keepdim=True).clamp(min=1e-30)
    return torch.einsum("bhgw,bwhd->bhgd", probs, vw).to(q.dtype)


def _check(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           pos: torch.Tensor, window: int) -> None:
    if q.dim() != 4 or k_cache.dim() != 4:
        raise ValueError(
            f"swa_attention_decode takes q (B, KVH, G, D) and a cache (B, S, KVH, D), "
            f"got {tuple(q.shape)} and {tuple(k_cache.shape)}"
        )
    b, s, kvh, d = k_cache.shape
    if v_cache.shape != k_cache.shape:
        raise ValueError(f"k and v caches differ: {tuple(k_cache.shape)} {tuple(v_cache.shape)}")
    if q.shape[0] != b or q.shape[1] != kvh or q.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} does not match the cache {tuple(k_cache.shape)}")
    if pos.shape != (b,) or pos.dtype != torch.int32:
        raise ValueError(f"pos must be ({b},) int32, got {tuple(pos.shape)} {pos.dtype}")
    if q.dtype not in _DTYPE_CODES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(
            f"swa_attention_decode takes float32 or bfloat16 q and caches of q's dtype, got "
            f"{q.dtype}, {k_cache.dtype}, {v_cache.dtype}"
        )
    if int(window) < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    devices = {t.device for t in (q, k_cache, v_cache, pos)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")


_LAUNCH = None


def _launcher():
    """The C entry point with its ctypes signature, loaded once."""
    global _LAUNCH
    if _LAUNCH is None:
        fn = _build.load("swa_attention").swa_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return _LAUNCH


def swa_attention_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                         pos: torch.Tensor, *, window: int) -> torch.Tensor:
    """out (B, KVH, G, D) in q's dtype: one-token decode attention over each
    row's last `window` cache positions before `pos` (the fill level)."""
    global launches
    _check(q, k_cache, v_cache, pos, window)
    device = q.device
    if device.type == "cpu":
        return swa_attention_decode_plain(q, k_cache, v_cache, pos, window=window)
    if device.type != "cuda":
        raise ValueError(f"swa_attention_decode runs on cpu or cuda tensors, got {device}")
    if not all(t.is_contiguous() for t in (q, k_cache, v_cache, pos)):
        raise ValueError("swa_attention_decode takes contiguous tensors on the card")
    b, s, kvh, d = k_cache.shape
    g = q.shape[2]
    code = _DTYPE_CODES[q.dtype]
    vec_bytes = 16
    if (d * q.element_size()) % vec_bytes or any(
            t.data_ptr() % vec_bytes for t in (q, k_cache, v_cache)):
        raise ValueError(
            f"the kernel loads 16-byte vectors: D * itemsize must be a multiple of 16 "
            f"and the tensors 16-byte aligned (D={d}, {q.dtype})"
        )
    if not 1 <= g <= _MAX_GROUPS:
        raise ValueError(f"the kernel takes 1 to {_MAX_GROUPS} query heads per kv head, got {g}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    launch = _launcher()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = launch(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
                     out.data_ptr(), code, b, s, kvh, g, d, int(window),
                     1.0 / float(d) ** 0.5, stream)
    if err == _ERR_SHARED_MEMORY:
        raise ValueError(
            f"swa_attention_decode: the float32 scores of G={g} query heads over a window of "
            f"{min(int(window), s)} positions do not fit in a block's shared memory"
        )
    if err != 0:
        raise RuntimeError(f"swa_attention launch failed with code {err}")
    launches += 1
    return out
