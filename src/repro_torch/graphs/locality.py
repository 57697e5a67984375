"""Stream-locality metrics: Neighbor-to-neighbor Average ID Distance (AID).

Paper Eq. (1): for node v with neighbors sorted by stream position,
AID_v = (1/d(v)) * sum_{i=2..d} |u_i - u_{i-1}|; graph AID = mean over nodes.
Lower = higher locality.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.csr import CSRGraph


def aid_per_node(g: CSRGraph) -> np.ndarray:
    """AID_v for every node (0 for nodes with degree < 2)."""
    out = np.zeros(g.n, dtype=np.float64)
    for v in range(g.n):
        nbrs = np.sort(g.neighbors(v).astype(np.int64))
        if nbrs.size >= 2:
            out[v] = np.abs(np.diff(nbrs)).sum() / nbrs.size
    return out


def mean_aid(g: CSRGraph) -> float:
    return float(aid_per_node(g).mean())


def geometric_mean(values: np.ndarray, eps: float = 1e-12) -> float:
    values = np.asarray(values, dtype=np.float64)
    return float(np.exp(np.log(np.maximum(values, eps)).mean()))
