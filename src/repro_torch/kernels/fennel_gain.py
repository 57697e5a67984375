"""Sequential Fennel sweep — the host engine of the initial partition.

`fennel_gain_sequential` is the scalar host loop the host multilevel
engines run on the coarsest graph (~10²-10³ nodes, small k), where per-step
array dispatch costs more than the arithmetic.  It is bit-identical to
`repro.kernels.fennel_gain.fennel_gain_sequential`.  The fused Pallas
`_fennel_kernel` of that module is not on this slice's path and is not
ported yet.
"""
from __future__ import annotations

import math

import numpy as np


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
