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
the cache and pads nothing at the shapes the kernel takes (D·itemsize a
multiple of 16 bytes, 16-byte aligned storage, G <= 16; the wrapper pads
D or splits G for the others).  It is bound by the bytes of K and V it reads,
and reaches that rate only with enough blocks and bytes in flight, so the
window is split ("flash-decoding"): `split_plan` cuts each row's window
into chunks so that B·KVH·splits gives every SM several blocks; each block
streams its chunk's K and V rows through shared memory with asynchronous
copies and writes the chunk's max, exp-sum and unnormalised output to a
float32 scratch, and the last block of a row (an integer counter per row)
merges the row's splits in split order.  bf16 at the LM
head widths runs on the tensor cores, other shapes on the CUDA cores.

Numerics: a split softmax with a fixed-order combine, not the Pallas
kernel's single pass.  Float32 sums of exact products (bf16 products on the
tensor cores, the float32 probabilities split into three bf16 parts that
sum to them exactly), the scale `1 / sqrt(D)` as a Python float, per chunk
`m = max s`, `l = Σ exp(s - m)` and `o = Σ exp(s - m)·v`, then
`out = Σ o_i·exp(m_i - M) / max(Σ l_i·exp(m_i - M), 1e-30)` with
`M = max m_i` and weight 0 for an empty chunk, so an empty window gives
zeros; the output is cast to q's dtype once.  It differs from the plain
version (one softmax over the window) by float32 rounding only, and two
launches on the same inputs are bit-identical (no float atomics).

`swa_attention_decode` has the reference wrapper's signature without its
`use_kernel` and `interpret` switches: it takes the plain version only for
tensors on the CPU, and for CUDA tensors it launches the kernel or raises.
`launches` counts kernel launches on the card (one a call for G <= 16, one
per group of 16 query heads above), and nothing else.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import _build

launches = 0
# several threads may launch at once, so each count is taken under this lock
_count_lock = threading.Lock()

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ERR_SHARED_MEMORY = -1
_ERR_SHAPE = -2
_MAX_GROUPS = 16  # query heads a KV head in one launch (csrc: kMaxGroups)
_VEC_BYTES = 16  # the kernel's vector loads

# the split plan (csrc/swa_attention.cu: kTile positions per ring stage)
TILE = 64
MIN_CHUNK = 128  # positions: fewer would spend more on the combine than they save
BLOCKS_PER_SM = 4  # split kernel blocks the plan asks for on every SM
SCORE_FLOATS = 4096  # chunk * G: the CUDA-core kernel keeps the chunk's scores (16 KB)


def split_plan(span: int, rows: int, groups: int, sm_count: int) -> tuple[int, int]:
    """(splits, chunk) for windows of at most `span` positions over `rows`
    = B·KVH rows: the fewest splits that give `sm_count` SMs BLOCKS_PER_SM
    blocks each, with chunks of at least MIN_CHUNK positions and at most
    SCORE_FLOATS / G; chunks are rounded up to whole tiles, which may leave
    a few blocks fewer (the serve shape: 32 rows x 16 splits of 256).  Split i of a row covers
    `[lo + i·chunk, min(hi, lo + (i + 1)·chunk))`; splits·chunk >= span, so
    every row's `[lo, hi)` is covered once.  A pure function of the shape
    and the card, so results do not depend on timing."""
    if span <= 0:
        return 1, TILE
    max_chunk = max(TILE, SCORE_FLOATS // groups // TILE * TILE)
    want = _ceil_div(BLOCKS_PER_SM * sm_count, max(rows, 1))
    splits = max(1, min(want, _ceil_div(span, MIN_CHUNK)))
    chunk = min(_ceil_div(_ceil_div(span, splits), TILE) * TILE, max_chunk)
    return _ceil_div(span, chunk), chunk


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


_plan = functools.lru_cache(maxsize=256)(split_plan)  # a decode step asks once a layer


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def swa_attention_decode_plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                               pos: torch.Tensor, *, window: int) -> torch.Tensor:
    """Plain PyTorch version: gathers each row's window of the cache and
    takes one float32 softmax over it (the kernel splits the window and
    agrees with this to float32 rounding)."""
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
    if pos.shape != (b,) or pos.dtype != torch.int32 and (
            pos.dtype.is_floating_point or pos.dtype.is_complex or pos.dtype == torch.bool):
        raise ValueError(f"pos must be ({b},) integers (taken as int32), got "
                         f"{tuple(pos.shape)} {pos.dtype}")
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
# per (device, stream): the float32 scratch of the splits' partials and the
# uint32 counters of the rows' finished splits.  Launches on one stream run
# in order, so they share both; the counters are zeroed once here and left
# zeroed by every launch (the last block of a row resets its counter), so a
# launch needs no memset and no allocation.
_WORKSPACE: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(index: int, stream: int, floats: int,
               rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    partial, counters = _WORKSPACE.get((index, stream), (None, None))
    device = torch.device("cuda", index)
    if partial is None or partial.numel() < floats:
        partial = torch.empty(floats, dtype=torch.float32, device=device)
    if counters is None or counters.numel() < rows:
        counters = torch.zeros(max(rows, 1024), dtype=torch.int32, device=device)
    _WORKSPACE[(index, stream)] = partial, counters
    return partial, counters


def _launcher():
    """The C entry point with its ctypes signature, loaded once."""
    global _LAUNCH
    if _LAUNCH is None:
        fn = _build.load("swa_attention").swa_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return _LAUNCH


def _pos_int32(pos: torch.Tensor) -> torch.Tensor:
    """pos as int32, refusing fill levels an int32 cannot hold."""
    if pos.dtype == torch.int32:
        return pos
    if pos.numel() and int(pos.max()) >= 2**31:
        raise ValueError(f"pos must fit in int32 (< 2**31), got {int(pos.max())}")
    return pos.to(torch.int32)


def _vec_padded(t: torch.Tensor, d_pad: int) -> torch.Tensor:
    """`t` zero-padded along its last dimension to `d_pad`, in fresh
    (allocator-aligned) storage."""
    out = t.new_zeros((*t.shape[:-1], d_pad))
    out[..., : t.shape[-1]] = t
    return out


def swa_attention_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                         pos: torch.Tensor, *, window: int) -> torch.Tensor:
    """out (B, KVH, G, D) in q's dtype: one-token decode attention over each
    row's last `window` cache positions before `pos` (the fill level).

    On the card it takes what the reference's op takes: non-contiguous
    tensors are made contiguous; an integer `pos` of another type is cast
    to int32 (values >= 2**31 are refused); where D·itemsize is no multiple
    of the kernel's 16-byte vectors, or a tensor is not 16-byte aligned,
    q and the caches are zero-padded along D in fresh storage (the zero
    columns add nothing to q·k and give zero output columns, which are cut
    off) with the scale still 1/sqrt(D); more than 16 query heads a KV head
    run as one launch per group of at most 16.  `launches` counts every
    kernel launch."""
    global launches
    _check(q, k_cache, v_cache, pos, window)
    device = q.device
    if device.type == "cpu":
        return swa_attention_decode_plain(q, k_cache, v_cache, _pos_int32(pos), window=window)
    if device.type != "cuda":
        raise ValueError(f"swa_attention_decode runs on cpu or cuda tensors, got {device}")
    # the serve path's calls pass every test below and take none of the
    # general paths' copies
    if pos.dtype != torch.int32 or not all(
            t.is_contiguous() for t in (q, k_cache, v_cache, pos)):
        q, k_cache, v_cache = (t.contiguous() for t in (q, k_cache, v_cache))
        pos = _pos_int32(pos).contiguous()
    b, s, kvh, d = k_cache.shape
    g = q.shape[2]
    vec = _VEC_BYTES // q.element_size()
    padded = d % vec != 0 or any(t.data_ptr() % _VEC_BYTES for t in (q, k_cache, v_cache))
    if padded:
        d_pad = _ceil_div(d, vec) * vec
        q, k_cache, v_cache = (_vec_padded(t, d_pad) for t in (q, k_cache, v_cache))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out[..., :d]
    index = device.index if device.index is not None else torch.cuda.current_device()
    scale = 1.0 / float(d) ** 0.5
    if g <= _MAX_GROUPS:
        _launch(q, k_cache, v_cache, pos, out, window, scale, index)
        with _count_lock:
            launches += 1
    else:
        for g0 in range(0, g, _MAX_GROUPS):
            part = torch.empty_like(q[:, :, g0:g0 + _MAX_GROUPS])
            _launch(q[:, :, g0:g0 + _MAX_GROUPS].contiguous(), k_cache, v_cache, pos, part,
                    window, scale, index)
            out[:, :, g0:g0 + _MAX_GROUPS] = part
            with _count_lock:
                launches += 1
    return out[..., :d] if padded else out


def _launch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, pos: torch.Tensor,
            out: torch.Tensor, window: int, scale: float, index: int) -> None:
    """One kernel launch on contiguous, 16-byte-vector tensors with at most
    16 query heads a KV head."""
    b, s, kvh, d = k_cache.shape
    g = q.shape[2]
    code = _DTYPE_CODES[q.dtype]
    splits, chunk = _plan(min(int(window), s), b * kvh, g, _sm_count(index))
    launch = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        # partial: (B, KVH, splits, G, D + 2)
        partial, counters = _workspace(index, stream, b * kvh * splits * g * (d + 2), b * kvh)
        err = launch(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
                     out.data_ptr(), partial.data_ptr(), counters.data_ptr(), code, b, s, kvh,
                     g, d, int(window), chunk, splits, scale, stream)
    if err == _ERR_SHARED_MEMORY:
        raise ValueError(
            f"swa_attention_decode: the kernel's ring of {q.dtype} K/V tiles of D={d} does not "
            f"fit in a block's shared memory"
        )
    if err == _ERR_SHAPE:
        raise ValueError(
            f"swa_attention_decode: the kernel does not take G={g}, D={d} in {q.dtype} "
            f"(its P.V columns outnumber a block's threads)"
        )
    if err != 0:
        raise RuntimeError(f"swa_attention launch failed with code {err}")
