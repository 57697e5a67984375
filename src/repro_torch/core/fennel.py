"""Fennel scoring [Tsourakakis et al., WSDM'14] for the port.

Assign v to the block maximizing g(v, V_i) = w(N(v) ∩ V_i) − f(c(V_i)) with
f(x) = alpha * gamma * x^(gamma-1), alpha = m * k^(gamma-1) / n^gamma,
subject to the hard cap c(V_i) + c(v) <= L_max.  The driver uses it for
the immediate hub assignment (paper Alg. 1); the multilevel engines reuse
`FennelParams` for the coarsest-level initial partition.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.metrics import l_max


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
