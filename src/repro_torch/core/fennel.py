"""Fennel one-pass streaming partitioning [Tsourakakis et al., WSDM'14].

Assign v to the block maximizing g(v, V_i) = w(N(v) ∩ V_i) − f(c(V_i)) with
f(x) = alpha * gamma * x^(gamma-1), alpha = m * k^(gamma-1) / n^gamma,
subject to the hard cap c(V_i) + c(v) <= L_max.  Used three ways: the
standalone one-pass baseline, the driver's immediate hub assignment (paper
Alg. 1), and `FennelParams` for the coarsest-level initial partition of the
multilevel engines.  Also provides LDG [Stanton & Kliot, KDD'12] as a second
one-pass baseline.  Both baselines are host numpy, as in the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core._deprecation import require_csr, warn_legacy
from repro_torch.core.metrics import l_max
from repro_torch.graphs.csr import CSRGraph


@dataclasses.dataclass
class FennelParams:
    k: int
    n_total: float  # total node weight c(V) of the *full* graph (known a priori)
    m_total: float  # total edge weight of the full graph
    eps: float = 0.03
    gamma: float = 1.5

    @property
    def alpha(self) -> float:
        n = max(self.n_total, 1.0)
        return self.m_total * self.k ** (self.gamma - 1.0) / (n**self.gamma)

    @property
    def cap(self) -> float:
        return l_max(self.n_total, self.k, self.eps)


def fennel_penalty(loads: np.ndarray, p: FennelParams) -> np.ndarray:
    return p.alpha * p.gamma * np.power(np.maximum(loads, 0.0), p.gamma - 1.0)


def block_connectivity(
    nbrs: np.ndarray, nbr_w: np.ndarray, block: np.ndarray, k: int
) -> np.ndarray:
    """w(N(v) ∩ V_i) for all i."""
    conn = np.zeros(k, dtype=np.float64)
    if nbrs.size:
        b = block[nbrs]
        ok = b >= 0
        np.add.at(conn, b[ok], nbr_w[ok])
    return conn


def fennel_choose(
    nbrs: np.ndarray,
    nbr_w: np.ndarray,
    node_w: float,
    block: np.ndarray,
    loads: np.ndarray,
    p: FennelParams,
) -> int:
    """Pick the Fennel-optimal feasible block (deterministic tie-break:
    least loaded, then lowest id)."""
    conn = block_connectivity(nbrs, nbr_w, block, p.k)
    score = conn - fennel_penalty(loads, p)
    feasible = loads + node_w <= p.cap
    if not feasible.any():  # degenerate: everything full — least-loaded
        return int(np.argmin(loads))
    score = np.where(feasible, score, -np.inf)
    best = score.max()
    cand = np.nonzero(score >= best - 1e-12)[0]
    if cand.size > 1:
        cand = cand[np.argsort(loads[cand], kind="stable")]
    return int(cand[0])


def fennel_partition(
    g: CSRGraph, k: int, eps: float = 0.03, gamma: float = 1.5
) -> np.ndarray:
    """Deprecated shim: `repro_torch.api.partition` is the front door."""
    warn_legacy("fennel_partition(g, k, eps, gamma)", "partition(g, driver='fennel', k=...)")
    return _fennel_partition(g, k, eps, gamma)


def _fennel_partition(
    g: CSRGraph, k: int, eps: float = 0.03, gamma: float = 1.5
) -> np.ndarray:
    """One-pass Fennel over the stream order (node id order)."""
    g = require_csr(g, "fennel")
    p = FennelParams(k=k, n_total=float(g.node_w.astype(np.float64).sum()),
                     m_total=g.total_edge_weight(), eps=eps, gamma=gamma)
    block = np.full(g.n, -1, dtype=np.int64)
    loads = np.zeros(k, dtype=np.float64)
    for v in range(g.n):
        i = fennel_choose(g.neighbors(v), g.neighbor_weights(v), float(g.node_w[v]), block,
                          loads, p)
        block[v] = i
        loads[i] += g.node_w[v]
    return block


def ldg_partition(g: CSRGraph, k: int, eps: float = 0.03) -> np.ndarray:
    """Deprecated shim: `repro_torch.api.partition` is the front door."""
    warn_legacy("ldg_partition(g, k, eps)", "partition(g, driver='ldg', k=...)")
    return _ldg_partition(g, k, eps)


def _ldg_partition(g: CSRGraph, k: int, eps: float = 0.03) -> np.ndarray:
    """Linear Deterministic Greedy: argmax |N(v) ∩ V_i| * (1 - c(V_i)/cap)."""
    g = require_csr(g, "ldg")
    cap = l_max(float(g.node_w.astype(np.float64).sum()), k, eps)
    block = np.full(g.n, -1, dtype=np.int64)
    loads = np.zeros(k, dtype=np.float64)
    for v in range(g.n):
        conn = block_connectivity(g.neighbors(v), g.neighbor_weights(v), block, k)
        score = conn * (1.0 - loads / cap)
        feasible = loads + g.node_w[v] <= cap
        score = np.where(feasible, score, -np.inf)
        if not feasible.any():
            i = int(np.argmin(loads))
        else:
            best = score.max()
            cand = np.nonzero(score >= best - 1e-12)[0]
            cand = cand[np.argsort(loads[cand], kind="stable")]
            i = int(cand[0])
        block[v] = i
        loads[i] += g.node_w[v]
    return block
