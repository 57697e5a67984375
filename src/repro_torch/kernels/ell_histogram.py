"""ELL neighbor-label histogram: the CUDA kernel, its wrapper and its plain version.

    counts[b, i] = Σ_w nbr_w[b, w] · [nbr_blk[b, w] == i]

`nbr_blk` is (B, W) int32 with -1 as padding, `nbr_w` (B, W) float32, and
`counts` (B, k) float32, accumulated in float32 in w order like the TPU
kernel (callers cast to float64 afterwards).

Replaces `repro/kernels/ell_histogram.py::_histogram_kernel` (wrapper
`repro/kernels/ops.py::block_histogram`, oracle
`repro/kernels/ref.py::ell_histogram_ref`).  The kernel,
`csrc/ell_histogram.cu`, is bound by memory traffic — B·W·8 bytes read and
B·k·4 bytes written, the output most of it — so it keeps its loads
independent (16-byte loads of a row's labels and weights, widths 8 to 64
specialised and unrolled) and writes each thread's 4 adjacent labels with
one 16-byte streaming store.  Each output element is summed by one thread
in w order, without atomics, so the kernel agrees with the plain version bit
for bit.  At the clustering's k = n_pad it stays bound by writing the
mostly-zero (B, k) output.

`block_histogram` takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.  `launches` counts kernel
launches and nothing else.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build

launches = 0
# several threads may launch at once (the sharded driver's workers), so
# each count is taken under this lock
_count_lock = threading.Lock()

_INT_MAX = 2**31 - 1


def ell_histogram_plain(nbr_blk: torch.Tensor, nbr_w: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version: the kernel's arithmetic, one W column at a
    time (float32 adds in w order, so it agrees with the kernel bit for
    bit)."""
    b, w = nbr_blk.shape
    counts = torch.zeros((b, k), dtype=torch.float32, device=nbr_blk.device)
    labels = torch.arange(k, dtype=nbr_blk.dtype, device=nbr_blk.device)
    for j in range(w):
        hit = nbr_blk[:, j : j + 1] == labels
        counts = counts + torch.where(hit, nbr_w[:, j : j + 1], 0.0)
    return counts


def _check(nbr_blk: torch.Tensor, nbr_w: torch.Tensor, k: int) -> None:
    if nbr_blk.dtype != torch.int32 or nbr_w.dtype != torch.float32:
        raise TypeError(
            f"block_histogram takes int32 labels and float32 weights, got "
            f"{nbr_blk.dtype} and {nbr_w.dtype}"
        )
    if nbr_blk.dim() != 2 or nbr_blk.shape != nbr_w.shape:
        raise ValueError(
            f"block_histogram takes two (B, W) tensors of one shape, got "
            f"{tuple(nbr_blk.shape)} and {tuple(nbr_w.shape)}"
        )
    if not (nbr_blk.is_contiguous() and nbr_w.is_contiguous()):
        raise ValueError("block_histogram takes contiguous tensors")
    if nbr_blk.device != nbr_w.device:
        raise ValueError(f"tensors on {nbr_blk.device} and {nbr_w.device}")
    if not 0 <= int(k) <= _INT_MAX:
        raise ValueError(f"k must lie in [0, 2^31), got {k}")


_LAUNCH = None


def _launcher():
    """The C entry point with its ctypes signature, loaded once."""
    global _LAUNCH
    if _LAUNCH is None:
        fn = _build.load("ell_histogram").ell_histogram_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return _LAUNCH


def block_histogram(nbr_blk: torch.Tensor, nbr_w: torch.Tensor, k: int) -> torch.Tensor:
    """counts (B, k) float32: the weighted per-row label histogram."""
    _check(nbr_blk, nbr_w, k)
    device = nbr_blk.device
    if device.type == "cpu":
        return ell_histogram_plain(nbr_blk, nbr_w, int(k))
    if device.type != "cuda":
        raise ValueError(f"block_histogram runs on cpu or cuda tensors, got {device}")
    return _histogram_on_card(nbr_blk, nbr_w, int(k))


def _histogram_on_card(nbr_blk: torch.Tensor, nbr_w: torch.Tensor, k: int) -> torch.Tensor:
    """The card path of `block_histogram`: one launch on the current
    stream of the tensors' device, counted."""
    global launches
    device = nbr_blk.device
    b, w = nbr_blk.shape
    counts = torch.empty((b, int(k)), dtype=torch.float32, device=device)
    if counts.numel() == 0:
        return counts
    launch = _launcher()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = launch(nbr_blk.data_ptr(), nbr_w.data_ptr(), counts.data_ptr(),
                     b, w, int(k), stream)
    if err != 0:
        raise RuntimeError(f"ell_histogram launch failed with CUDA error {err}")
    with _count_lock:
        launches += 1
    return counts
