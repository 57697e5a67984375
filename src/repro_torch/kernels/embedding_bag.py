"""Embedding bag: the CUDA kernel, its wrapper and its plain version.

    pooled[b] = Σ_l table[clamp(idx[b, l], 0, V − 1)] · mask[b, l]

in two forms: the reference's 2-D one, table (V, D), idx (B, L) int32 and
mask (B, L) float32 → (B, D), and the stacked one, table (T, V, D), idx
(B, T, L) and mask (B, T, L) → (B, T, D), which is what `jax.vmap` of the
2-D op over DLRM's 26 tables computes, here in one launch.

Replaces `repro/kernels/embedding_bag.py::_bag_kernel` and what its wrapper
`repro/kernels/ops.py::embedding_bag` does around it (oracle
`repro/kernels/ref.py::embedding_bag_ref`).  The reference clamps idx to
[0, V) and pads D to 128 lanes; here the kernel, `csrc/embedding_bag.cu`,
clamps each index as it reads it and pads nothing.  It is bound by the
bytes of the rows it gathers and of the pooled rows it writes.  Its sum is
the plain version's loop: from a zero accumulator, for l in order, a
float32 multiply and then an add, so the two agree bit for bit.

`embedding_bag` has the reference wrapper's signature without its
`use_kernel` and `interpret` switches: it takes the plain version only for
tensors on the CPU, and for CUDA tensors it launches the kernel or raises.
The kernel has no backward: on a CUDA table that requires grad, with grad
mode on, the op raises rather than return a result with no gradient (the
plain version is differentiable on every device, and DLRM's training loss
pools through it, as the reference's does).
`launches` counts kernel launches and nothing else.  (The package
`repro_torch.kernels` exports the op `embedding_bag` under this module's
name, as the reference's does: reach the module itself with
`importlib.import_module("repro_torch.kernels.embedding_bag")`.)
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build

launches = 0
# several threads may launch at once, so each count is taken under this lock
_count_lock = threading.Lock()


def _stacked(table: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor):
    """The stacked (T, V, D), (B, T, L), (B, T, L) views of either form."""
    if table.dim() == 2:
        return table[None], idx[:, None], mask[:, None]
    return table, idx, mask


def embedding_bag_plain(table: torch.Tensor, idx: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the kernel's arithmetic, one bag slot at a
    time (a float32 multiply, then an add, in l order)."""
    two_d = table.dim() == 2
    tab, ix, mk = _stacked(table, idx, mask)
    t, v, d = tab.shape
    b, _, n_slots = ix.shape
    ix = ix.clamp(0, v - 1).long()
    tables = torch.arange(t, device=tab.device)[None, :]
    out = torch.zeros((b, t, d), dtype=tab.dtype, device=tab.device)
    for slot in range(n_slots):
        out = out + tab[tables, ix[:, :, slot]] * mk[:, :, slot, None]
    return out[:, 0] if two_d else out


def _check(table: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor) -> None:
    if table.dtype != torch.float32 or mask.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(
            f"embedding_bag takes a float32 table, int32 idx and a float32 mask, got "
            f"{table.dtype}, {idx.dtype} and {mask.dtype}"
        )
    if table.dim() not in (2, 3) or idx.dim() != table.dim() or idx.shape != mask.shape:
        raise ValueError(
            f"embedding_bag takes (V, D), (B, L), (B, L) or (T, V, D), (B, T, L), (B, T, L), "
            f"got {tuple(table.shape)}, {tuple(idx.shape)} and {tuple(mask.shape)}"
        )
    if table.dim() == 3 and idx.shape[1] != table.shape[0]:
        raise ValueError(f"idx {tuple(idx.shape)} does not name the {table.shape[0]} tables")
    if table.shape[-2] == 0:
        raise ValueError("embedding_bag needs a table of at least one row")
    if not all(t.is_contiguous() for t in (table, idx, mask)):
        raise ValueError("embedding_bag takes contiguous tensors")
    devices = {t.device for t in (table, idx, mask)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")


_LAUNCH = None


def _launcher():
    """The C entry point with its ctypes signature, loaded once."""
    global _LAUNCH
    if _LAUNCH is None:
        fn = _build.load("embedding_bag").embedding_bag_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return _LAUNCH


def embedding_bag(table: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Pooled embedding lookup: (B, D) from a (V, D) table, or (B, T, D)
    from T stacked (T, V, D) tables; idx is clamped to [0, V)."""
    global launches
    _check(table, idx, mask)
    device = table.device
    if device.type == "cpu":
        return embedding_bag_plain(table, idx, mask)
    if device.type != "cuda":
        raise ValueError(f"embedding_bag runs on cpu or cuda tensors, got {device}")
    if table.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(
            "embedding_bag: the CUDA kernel has no backward, so a gradient for a table "
            "that requires grad would silently be missing; train through "
            "embedding_bag_plain, as models.dlrm.dlrm_loss does, or call under "
            "torch.no_grad() to serve")
    tab, ix, _ = _stacked(table, idx, mask)
    t, v, d = tab.shape
    b, _, n_slots = ix.shape
    out = torch.empty((b, t, d) if table.dim() == 3 else (b, d), dtype=torch.float32,
                      device=device)
    if out.numel() == 0:
        return out
    launch = _launcher()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = launch(table.data_ptr(), idx.data_ptr(), mask.data_ptr(), out.data_ptr(),
                     b * t, t, v, d, n_slots, stream)
    if err != 0:
        raise RuntimeError(f"embedding_bag launch failed with CUDA error {err}")
    with _count_lock:
        launches += 1
    return out
