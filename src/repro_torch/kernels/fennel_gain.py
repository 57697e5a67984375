"""Fennel decisions on the card: the public op `fennel_choose_batch` and
the V-cycle's initial sweep `fennel_sweep`, each a CUDA kernel of
`csrc/fennel_gain.cu` beside its plain version; and the sequential host
sweep.

`fennel_choose_batch` is the public op of the reference
(`repro/kernels/ops.py::fennel_choose_batch`): a wavefront Fennel decision
for a tile of nodes that all see the same loads,

    best[b] = first argmax_i  counts[b, i] − α·γ·max(loads_i, 0)^(γ−1)
              over the blocks with loads_i + node_w[b] ≤ cap,
              or the first argmin of the k loads when no block is feasible,

with `counts` the weighted ELL histogram of `kernels/ell_histogram.py`,
returning (best int32 (B,), best score float32 (B,)).  It replaces
`repro/kernels/fennel_gain.py::_fennel_kernel` with the kernel behind
`fennel_gain_launch`, which fuses the histogram, the penalty, the
feasibility mask and the argmax so that nothing of size (B, k) reaches
device memory, one launch a call, for any k (a k whose loads and penalty
do not fit in shared memory reads them from device memory); it is bound by
the B·W·8 bytes of rows it reads.  It follows the oracle
`repro/kernels/ref.py::fennel_gain_ref` where the reference's two routes
differ: an infeasible score is −inf (the
Pallas kernel writes −1e30), and the fallback is the argmin over the k real
loads (the Pallas route pads the loads with 2·cap + 1 and returns a padded
id when every real load exceeds that).  The kernel computes the penalty
with the float32 operations that `fennel_penalty_plain`'s torch ops perform
on the card, so the chosen block equals the plain version's bit for bit.
`launches` counts its launches.

`fennel_sweep` is the V-cycle's initial partition on the coarsest level
(`core/multilevel_torch.py::_initial_fennel`): the same decision in float64
applied to the free nodes one after another in `order`, each step seeing
the labels and loads of the steps before it.  It replaces the reference's
`repro/core/multilevel_jax.py::_initial_fennel`, a `jax.lax.fori_loop` (not
a Pallas kernel), with the one-block kernel behind `fennel_sweep_launch`:
one launch instead of ~20 eager launches per step.  For k <= 32 the kernel
forms each step's scores one step ahead, for both outcomes of the step
before, so that a step's dependent chain is a select and one pair of warp
reductions (`csrc/fennel_gain.cu`).  Its plain version,
`fennel_sweep_plain`, is that eager step loop.  The kernel sums a segment
in segment order unless its sum is exact in any order (integer weights
summing below 2^53), and the plain version in torch's reduction order, so
the two agree bit for bit where the sums are exact (integer weights, as
BuffCut's graphs have; the V-cycle's parity with the host engines holds
on those only).
`sweep_launches` counts its launches; `_sweep_stamped` runs a copy of the
kernel with cycle counters for `chip_smoke.py` and is not counted.

Each wrapper takes its plain version only for tensors on the CPU; for
CUDA tensors it launches its kernel or raises.

`fennel_gain_sequential` is the scalar host loop the host multilevel
engines run on the coarsest graph (~10²-10³ nodes, small k), where per-step
array dispatch costs more than the arithmetic.  It is bit-identical to
`repro.kernels.fennel_gain.fennel_gain_sequential`.
"""
from __future__ import annotations

import ctypes
import math
import threading

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ell_histogram import ell_histogram_plain

launches = 0
sweep_launches = 0
# several threads may launch at once (the sharded driver's workers), so
# each count is taken under this lock
_count_lock = threading.Lock()

_ERR_SHARED_MEMORY = -1
_ERR_SHAPE = -2


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


def _pow_tensor(g1: float):
    """Tensor twin of `np.power(m, g1)` with numpy's fast paths (x*x, sqrt,
    1/x), so the sweep's penalty matches the host engines bit for bit at
    those exponents; other exponents use the device's pow."""
    if g1 == 2.0:
        return lambda m: m * m
    if g1 == 0.5:
        return torch.sqrt
    if g1 == -1.0:
        return lambda m: 1.0 / m
    return lambda m: torch.pow(m, g1)


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
_SWEEP = None
_STAMPED = None


def _launcher():
    """The public op's C entry point with its ctypes signature, loaded once."""
    global _LAUNCH
    if _LAUNCH is None:
        fn = _build.load("fennel_gain").fennel_gain_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
            ctypes.c_double, ctypes.c_double, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return _LAUNCH


def _sweep_launcher():
    """The sweep's C entry point with its ctypes signature, loaded once."""
    global _SWEEP
    if _SWEEP is None:
        fn = _build.load("fennel_gain").fennel_sweep_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _SWEEP = fn
    return _SWEEP


def _stamped_launcher():
    """The stamped sweep's C entry point, loaded once (`_sweep_stamped`)."""
    global _STAMPED
    if _STAMPED is None:
        fn = _build.load("fennel_gain").fennel_sweep_stamped_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _STAMPED = fn
    return _STAMPED


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
    launch = _launcher()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = launch(nbr_blk.data_ptr(), nbr_w.data_ptr(), loads.data_ptr(), node_w.data_ptr(),
                     best.data_ptr(), score.data_ptr(), b, w, k, float(cap),
                     float(alpha) * float(gamma), float(gamma) - 1.0, stream)
    if err != 0:
        raise RuntimeError(f"fennel_gain launch failed with CUDA error {err}")
    with _count_lock:
        launches += 1
    return best, score


def fennel_sweep_plain(esrc, edst, ew, node_w, order, indptr, labels, loads, n_free: int, *,
                       alpha: float, gamma: float, cap: float, w_c: int):
    """Plain PyTorch version of the sweep: one eager step per free node.
    Each step gathers v's own edge segment at the fixed width `w_c` (at
    least the largest free segment; the edge arrays are src-sorted) and
    reduces it with a (w_c, k) one-hot product.  Returns (labels, loads)."""
    n_pad = node_w.shape[0]
    e_pad = esrc.shape[0]
    k = loads.shape[0]
    dev = node_w.device
    labels, loads = labels.clone(), loads.clone()
    blk_ids = torch.arange(k, device=dev)
    cols = torch.arange(w_c, device=dev)
    ag = float(alpha) * float(gamma)
    powf = _pow_tensor(float(gamma) - 1.0)
    for i in range(n_free):
        v = order[i : i + 1]
        # clamp the segment window into the array, as a fixed-width slice
        # would; `own` masks the entries that are not v's
        idx = indptr[v].clamp(max=e_pad - w_c) + cols
        seg_dst = edst[idx]
        own = esrc[idx] == v
        lab = torch.where(own & (seg_dst < n_pad), labels[seg_dst.clamp(max=n_pad - 1)], -1)
        contrib = torch.where(lab >= 0, ew[idx], 0.0)
        conn = (contrib[:, None] * (lab[:, None] == blk_ids)).sum(0)
        score = conn - ag * powf(loads.clamp(min=0.0))
        nw = node_w[v]
        feasible = loads + nw <= cap
        blk = torch.where(feasible.any(),
                          torch.where(feasible, score, -math.inf).argmax(),
                          loads.argmin()).view(1)
        labels[v] = blk
        loads = loads + nw * (blk_ids == blk)
    return labels, loads


def _check_sweep(esrc, edst, ew, node_w, order, indptr, labels, loads, n_free: int) -> None:
    n_pad, k = node_w.shape[0], loads.shape[0]
    want = {"esrc": (esrc, torch.int64), "edst": (edst, torch.int64), "ew": (ew, torch.float64),
            "node_w": (node_w, torch.float64), "order": (order, torch.int64),
            "indptr": (indptr, torch.int64), "labels": (labels, torch.int64),
            "loads": (loads, torch.float64)}
    for name, (t, dtype) in want.items():
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise TypeError(f"fennel_sweep: {name} must be a contiguous 1-D {dtype} tensor, "
                            f"got {t.dtype} {tuple(t.shape)}")
    if not (edst.shape == ew.shape == esrc.shape):
        raise ValueError("fennel_sweep: esrc, edst and ew must have one length")
    if order.shape[0] < n_free or labels.shape[0] != n_pad or indptr.shape[0] != n_pad + 1:
        raise ValueError(
            f"fennel_sweep: order must hold n_free={n_free} nodes, labels n_pad={n_pad} and "
            f"indptr n_pad + 1; got {order.shape[0]}, {labels.shape[0]}, {indptr.shape[0]}")
    if k == 0:
        raise ValueError("fennel_sweep: loads must be (k,) with k >= 1")
    devices = {t.device for t, _ in want.values()}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")


# what `_sweep_stamped` returns, in the order of the kernel's counters:
# the decision warp's cycles by branch of a step (the main block, which
# decides a step and prepares the next; the settle on full keys; the
# ordered sums of the next step; the tail: label store, releases, waits),
# before the loop and in all; steps; steps settled on full keys (a tie in
# the keys' top 27 bits, or no score above -inf) and steps with no
# feasible block; prepared steps by summation path (segments past kSlots =
# 8 entries and past kDirect = 1024, fractional ones that hold the node of
# the step before, short exact ones that hold it and took its weight as
# one add; the rest need no patch); the chain alone, iterated; the
# decision warp's waits on the stager (cycles, waits); the stager's cycles
# other than its waits for room, and its batches of 32 steps
STAMP_KEYS = ("main_cycles", "settle_cycles", "ordered_cycles", "tail_cycles",
              "prologue_cycles", "total_cycles", "steps", "settle_steps", "fallback_steps",
              "long_steps", "direct_steps", "ordered_steps", "exact_steps", "chain_cycles",
              "chain_reps", "wait_cycles", "waits", "stage_cycles", "stage_batches")


def _sweep_stamped(esrc, edst, ew, node_w, order, indptr, labels0, loads0, n_free: int, *,
                   alpha: float, gamma: float, cap: float) -> tuple:
    """The sweep kernel with clock64() counters, on CUDA tensors of the
    main path's route only (k <= 32, labels in shared memory, gamma 1.5):
    (labels, loads, {STAMP_KEYS: int}).  The counters change the kernel's
    schedule, so its time is not the kernel's; it is not counted in
    `sweep_launches`."""
    _check_sweep(esrc, edst, ew, node_w, order, indptr, labels0, loads0, n_free)
    device = node_w.device
    if device.type != "cuda":
        raise ValueError(f"_sweep_stamped runs on cuda tensors only, got {device}")
    stamps = torch.zeros((len(STAMP_KEYS),), dtype=torch.int64, device=device)
    labels, loads, err = _launch_sweep(_stamped_launcher(), edst, ew, node_w, order, indptr,
                                       labels0, loads0, n_free, alpha, gamma, cap,
                                       stamps.data_ptr())
    if err == _ERR_SHAPE:
        raise ValueError("_sweep_stamped takes k <= 32, labels that fit in shared memory and "
                         "gamma = 1.5 only")
    if err != 0:
        raise RuntimeError(f"fennel_sweep_stamped launch failed with CUDA error {err}")
    return labels, loads, dict(zip(STAMP_KEYS, stamps.tolist()))


def _launch_sweep(launch, edst, ew, node_w, order, indptr, labels0, loads0, n_free, alpha,
                  gamma, cap, *extra):
    """One launch of a sweep entry point on CUDA tensors, into clones of
    labels0 and loads0: (labels, loads, the entry point's error code)."""
    device = node_w.device
    labels, loads = labels0.clone(), loads0.clone()
    k = loads.shape[0]
    scratch = torch.empty((3 * k,), dtype=torch.float64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = launch(edst.data_ptr(), ew.data_ptr(), node_w.data_ptr(), order.data_ptr(),
                     indptr.data_ptr(), labels.data_ptr(), loads.data_ptr(), scratch.data_ptr(),
                     node_w.shape[0], n_free, k, float(alpha) * float(gamma),
                     float(gamma) - 1.0, float(cap), stream, *extra)
    return labels, loads, err


def fennel_sweep(esrc, edst, ew, node_w, order, indptr, labels0, loads0, n_free: int, *,
                 alpha: float, gamma: float, cap: float, w_c: int):
    """The sequential weighted Fennel sweep over the first `n_free` nodes of
    `order`: returns (labels int64 (n_pad,), loads float64 (k,)), leaving
    labels0 and loads0 as they were.  `indptr` (n_pad + 1) gives each node's
    segment of the src-sorted edge arrays; `w_c` (the plain version's
    window) is at least the longest free segment and does not change the
    result.  On CPU tensors this is `fennel_sweep_plain`; on CUDA tensors
    one launch of the sweep kernel."""
    global sweep_launches
    _check_sweep(esrc, edst, ew, node_w, order, indptr, labels0, loads0, n_free)
    device = node_w.device
    if device.type == "cpu":
        return fennel_sweep_plain(esrc, edst, ew, node_w, order, indptr, labels0, loads0,
                                  n_free, alpha=alpha, gamma=gamma, cap=cap, w_c=w_c)
    if device.type != "cuda":
        raise ValueError(f"fennel_sweep runs on cpu or cuda tensors, got {device}")
    if n_free <= 0:
        return labels0.clone(), loads0.clone()
    k = loads0.shape[0]
    labels, loads, err = _launch_sweep(_sweep_launcher(), edst, ew, node_w, order, indptr,
                                       labels0, loads0, n_free, alpha, gamma, cap)
    if err == _ERR_SHARED_MEMORY:
        raise ValueError("fennel_sweep: the staging ring does not fit in a block's shared memory")
    if err == _ERR_SHAPE:
        raise ValueError(f"fennel_sweep: n_free={n_free}, k={k} and n_pad={node_w.shape[0]} "
                         f"are outside what the kernel takes")
    if err != 0:
        raise RuntimeError(f"fennel_sweep launch failed with CUDA error {err}")
    with _count_lock:
        sweep_launches += 1
    return labels, loads
