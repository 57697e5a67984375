"""Fennel gain and argmax: the fused CUDA kernel, its wrapper and its plain
version, and the sequential host sweep.

`fennel_choose_batch` is the public op of the reference
(`repro/kernels/ops.py::fennel_choose_batch`): a wavefront Fennel decision
for a tile of nodes that all see the same loads,

    best[b] = first argmax_i  counts[b, i] − α·γ·max(loads_i, 0)^(γ−1)
              over the blocks with loads_i + node_w[b] ≤ cap,
              or the first argmin of the k loads when no block is feasible,

with `counts` the weighted ELL histogram of `kernels/ell_histogram.py`,
returning (best int32 (B,), best score float32 (B,)).  It replaces
`repro/kernels/fennel_gain.py::_fennel_kernel` with `csrc/fennel_gain.cu`,
which fuses the histogram, the penalty, the feasibility mask and the
argmax so that nothing of size (B, k) reaches device memory; it is bound by
the B·W·8 bytes of rows it reads.  It follows the oracle
`repro/kernels/ref.py::fennel_gain_ref` where the reference's two routes
differ: an infeasible score is −inf (the Pallas kernel writes −1e30), and
the fallback is the argmin over the k real loads (the Pallas route pads the
loads with 2·cap + 1 and returns a padded id when every real load exceeds
that).  The penalty vector is computed once per call with torch ops
(`fennel_penalty_plain`) and handed to the kernel, so the chosen block
equals the plain version's bit for bit.  The wrapper takes the plain
version only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises.  `launches` counts kernel launches and nothing else.

`fennel_gain_sequential` is the scalar host loop the host multilevel
engines run on the coarsest graph (~10²-10³ nodes, small k), where per-step
array dispatch costs more than the arithmetic.  It is bit-identical to
`repro.kernels.fennel_gain.fennel_gain_sequential`.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ell_histogram import ell_histogram_plain

launches = 0

_ERR_SHARED_MEMORY = -1


def _pow_scalar(g1: float):
    """Scalar twin of the `np.power(m, g1)` array loop: numpy special-cases
    exponents 2.0 (x*x), 0.5 (sqrt) and -1.0 (1/x) in its broadcast loop,
    so the scalar path takes the same fast paths to stay bit-identical;
    every other exponent matches scalar np.power exactly."""
    if g1 == 2.0:
        return lambda m: m * m
    if g1 == 0.5:
        return math.sqrt
    if g1 == -1.0:
        return lambda m: 1.0 / m
    return lambda m: float(np.power(m, g1))


def fennel_gain_sequential(
    indptr: np.ndarray,
    indices: np.ndarray,
    edge_w: np.ndarray,
    node_w: np.ndarray,
    order: np.ndarray,
    labels: np.ndarray,
    loads: np.ndarray,
    *,
    alpha: float,
    gamma: float,
    cap: float,
    k: int,
) -> None:
    """Sequential Fennel sweep over `order`, mutating labels/loads in place.

    Connectivity accumulates float64 left-to-right in CSR adjacency order;
    the penalty is (alpha*gamma) * m**(gamma-1) with numpy's pow fast paths
    (`_pow_scalar`); feasible scores compare with strict `>` (first max);
    the all-infeasible fallback is the first minimum of the loads.
    """
    ag = float(alpha) * float(gamma)
    powf = _pow_scalar(float(gamma) - 1.0)
    cap = float(cap)
    loads_l = loads.tolist()
    labels_l = labels.tolist()
    conn = [0.0] * k
    ip = indptr.tolist()
    idx = indices.tolist()
    ew = edge_w.tolist()
    nws = node_w.tolist()
    rng = range(k)
    for v in order.tolist():
        for i in rng:
            conn[i] = 0.0
        for j in range(ip[v], ip[v + 1]):
            b = labels_l[idx[j]]
            if b >= 0:
                conn[b] += ew[j]
        nw = nws[v]
        best_i = -1
        best_s = -math.inf
        for i in rng:
            li = loads_l[i]
            if li + nw > cap:
                continue
            m = li if li > 0.0 else 0.0
            s = conn[i] - ag * powf(m)
            if s > best_s:
                best_s = s
                best_i = i
        if best_i < 0:
            best_i = loads_l.index(min(loads_l))
        labels_l[v] = best_i
        loads_l[best_i] = loads_l[best_i] + nw
    labels[:] = labels_l
    loads[:] = loads_l


def fennel_penalty_plain(loads: torch.Tensor, alpha: float, gamma: float) -> torch.Tensor:
    """α·γ·max(loads, 0)^(γ−1) as float32 torch ops, in the reference's
    order: the product α·γ as a Python float, then times the power."""
    return float(alpha) * float(gamma) * torch.pow(loads.clamp(min=0.0), float(gamma) - 1.0)


def fennel_gain_plain(nbr_blk: torch.Tensor, nbr_w: torch.Tensor, loads: torch.Tensor,
                      node_w: torch.Tensor, *, alpha: float, gamma: float,
                      cap: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the kernel's float32 arithmetic on a
    materialized (B, k) score matrix (the oracle's steps)."""
    k = loads.shape[0]
    counts = ell_histogram_plain(nbr_blk, nbr_w, k)
    score = counts - fennel_penalty_plain(loads, alpha, gamma)[None, :]
    cap32 = float(torch.tensor(cap, dtype=torch.float32))  # cap rounded to float32, on the host
    feasible = (loads[None, :] + node_w[:, None]) <= cap32
    masked = torch.where(feasible, score, -math.inf)
    best = torch.where(feasible.any(dim=1), masked.argmax(dim=1), loads.argmin())
    return best.to(torch.int32), masked.gather(1, best[:, None])[:, 0]


def _check(nbr_blk: torch.Tensor, nbr_w: torch.Tensor, loads: torch.Tensor,
           node_w: torch.Tensor) -> None:
    if nbr_blk.dtype != torch.int32 or nbr_w.dtype != torch.float32:
        raise TypeError(
            f"fennel_choose_batch takes int32 labels and float32 weights, got "
            f"{nbr_blk.dtype} and {nbr_w.dtype}"
        )
    if not (loads.is_floating_point() and node_w.is_floating_point()):
        raise TypeError(f"loads and node_w must be floating, got {loads.dtype}, {node_w.dtype}")
    if nbr_blk.dim() != 2 or nbr_blk.shape != nbr_w.shape:
        raise ValueError(
            f"fennel_choose_batch takes two (B, W) tensors of one shape, got "
            f"{tuple(nbr_blk.shape)} and {tuple(nbr_w.shape)}"
        )
    if loads.dim() != 1 or loads.shape[0] == 0:
        raise ValueError(f"loads must be (k,) with k >= 1, got {tuple(loads.shape)}")
    if node_w.shape != (nbr_blk.shape[0],):
        raise ValueError(f"node_w must be ({nbr_blk.shape[0]},), got {tuple(node_w.shape)}")
    if not (nbr_blk.is_contiguous() and nbr_w.is_contiguous()):
        raise ValueError("fennel_choose_batch takes contiguous tensors")
    devices = {t.device for t in (nbr_blk, nbr_w, loads, node_w)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")


_LAUNCH = None


def _launcher():
    """The C entry point with its ctypes signature, loaded once."""
    global _LAUNCH
    if _LAUNCH is None:
        fn = _build.load("fennel_gain").fennel_gain_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return _LAUNCH


def fennel_choose_batch(nbr_blk: torch.Tensor, nbr_w: torch.Tensor, loads: torch.Tensor,
                        node_w: torch.Tensor, *, alpha: float, gamma: float,
                        cap: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Wavefront Fennel assignment for a tile of nodes: (best block int32
    (B,), its score float32 (B,), −inf when no block is feasible).  loads
    and node_w are taken in float32."""
    global launches
    _check(nbr_blk, nbr_w, loads, node_w)
    loads = loads.to(torch.float32).contiguous()
    node_w = node_w.to(torch.float32).contiguous()
    device = nbr_blk.device
    if device.type == "cpu":
        return fennel_gain_plain(nbr_blk, nbr_w, loads, node_w, alpha=alpha, gamma=gamma,
                                 cap=cap)
    if device.type != "cuda":
        raise ValueError(f"fennel_choose_batch runs on cpu or cuda tensors, got {device}")
    b, w = nbr_blk.shape
    k = loads.shape[0]
    best = torch.empty((b,), dtype=torch.int32, device=device)
    score = torch.empty((b,), dtype=torch.float32, device=device)
    if b == 0:
        return best, score
    penalty = fennel_penalty_plain(loads, alpha, gamma).contiguous()
    launch = _launcher()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = launch(nbr_blk.data_ptr(), nbr_w.data_ptr(), loads.data_ptr(), penalty.data_ptr(),
                     node_w.data_ptr(), best.data_ptr(), score.data_ptr(), b, w, k, float(cap),
                     stream)
    if err == _ERR_SHARED_MEMORY:
        raise ValueError(
            f"fennel_choose_batch: the shared-memory row of k={k} blocks (loads and penalty, "
            f"{8 * k} bytes) does not fit in a block's shared memory"
        )
    if err != 0:
        raise RuntimeError(f"fennel_gain launch failed with CUDA error {err}")
    launches += 1
    return best, score
