"""Carry inputs from a `repro` (JAX package) run into the port.

The port shares no code with the JAX package, so what crosses over is
plain data: a graph's CSR arrays and a driver configuration's dict.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.buffcut import BuffCutConfig
from repro_torch.graphs.csr import CSRGraph


def graph_from_numpy(
    indptr: np.ndarray, indices: np.ndarray, edge_w: np.ndarray, node_w: np.ndarray
) -> CSRGraph:
    """The port's graph from a reference `CSRGraph`'s four arrays (copied,
    in the CSR's own dtypes)."""
    return CSRGraph(
        indptr=np.array(indptr, dtype=np.int64),
        indices=np.array(indices, dtype=np.int32),
        edge_w=np.array(edge_w, dtype=np.float32),
        node_w=np.array(node_w, dtype=np.float32),
    )


def buffcut_config_from_dict(d: dict) -> BuffCutConfig:
    """The port's config from a reference `BuffCutConfig.to_dict()`.

    The reference's device engine `"jax"` maps to the port's `"torch"`;
    the device is the config's own (default "cuda") unless `d["ml"]`
    names one.
    """
    d = dict(d)
    ml = dict(d.get("ml") or {})
    if ml.get("engine") == "jax":
        ml["engine"] = "torch"
    d["ml"] = ml
    return BuffCutConfig.from_dict(d)
