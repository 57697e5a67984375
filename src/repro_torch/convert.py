"""Carry inputs from a `repro` (JAX package) run into the port.

The port shares no code with the JAX package, so what crosses over is
plain data: a graph's CSR arrays, a driver configuration's dict, a
transformer's, a DLRM's or a GNN's parameter arrays, and an AdamW state.
Onto a device mesh, the same numpy arrays go through
`train/elastic.py::reshard_state`, which places each leaf's block on its
rank under the family's sharding rules.
"""
from __future__ import annotations

import numpy as np
import torch  # repro: noqa RPR001 -- weight converter; never on the partitioning path

from repro_torch.core.buffcut import BuffCutConfig
from repro_torch.graphs.csr import CSRGraph
from repro_torch.models.transformer import TransformerConfig
from repro_torch.train.adamw import AdamWState
from repro_torch.tree import tree_map


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


def transformer_params_from_numpy(params: dict[str, np.ndarray], cfg: TransformerConfig,
                                  device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """The port's parameter dict from a reference `init_params` pytree (each
    leaf as a numpy array, bfloat16 ones included): same keys and shapes,
    in the config's dtype on `device`.  Values pass through float32, which
    holds every bfloat16 and float32 value exactly."""
    return {
        name: torch.from_numpy(np.array(arr, dtype=np.float32)).to(
            device=device, dtype=cfg.torch_dtype)
        for name, arr in params.items()
    }


def dlrm_params_from_numpy(params: dict, device: str | torch.device = "cuda") -> dict:
    """The port's DLRM parameter dict from a reference `dlrm_init` pytree
    with numpy leaves: `tables` (T, V, D), and the `bot` and `top` MLPs'
    `w{i}` (fan_in, fan_out) and `b{i}`, copied as float32 onto `device`
    under the same keys."""
    def leaf(arr) -> torch.Tensor:
        return torch.from_numpy(np.array(arr, dtype=np.float32)).to(device)

    return {
        "tables": leaf(params["tables"]),
        "bot": {name: leaf(arr) for name, arr in params["bot"].items()},
        "top": {name: leaf(arr) for name, arr in params["top"].items()},
    }


def gnn_params_from_numpy(params: dict, device: str | torch.device = "cuda") -> dict:
    """The port's GNN parameter dict from a reference `*_init` pytree with
    numpy leaves: the same nested keys (MLP dicts of `w{i}`, `b{i}`, and
    SchNet's `species_embed` array), each leaf a float32 copy on `device`."""
    return tree_map(lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(device),
                    params)


def adamw_state_from_numpy(state, device: str | torch.device = "cuda") -> AdamWState:
    """The port's `AdamWState` from a reference `AdamWState(m, v, count)`
    with numpy leaves: float32 moments and an int32 count on `device`."""
    m, v, count = state
    return AdamWState(
        m=gnn_params_from_numpy(m, device),
        v=gnn_params_from_numpy(v, device),
        count=torch.tensor(int(np.asarray(count)), dtype=torch.int32, device=device),
    )
