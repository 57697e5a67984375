"""Shared shape definitions and input specs for the GNN archs (counterpart
of `repro/configs/gnn_common.py`).

The four assigned GNN shapes:
  full_graph_sm  Cora-scale full-batch           (n=2708, e=10556, f=1433)
  minibatch_lg   Reddit-scale sampled training   (232965 nodes, fanout 15-10,
                 batch_nodes=1024 -> layered block: 1024 + 15360 + 153600
                 node slots, 168960 block edges)
  ogb_products   full-batch large                (n=2449029, e=61859140, f=100)
  molecule       batched small graphs            (30 nodes, 64 edges, batch 128)

Every shape lowers to a fixed-size edge-list subgraph so all four GNN
archs share one train-step signature.  Directed CSR entries = 2x
undirected edges.  Input specs are `(shape, torch.dtype)`; the smoke
batch is drawn by the reference's numpy calls, so its values equal the
reference's (CPU tensors).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ShapeDef

F32, I32 = torch.float32, torch.int32

FANOUT = (15, 10)
BATCH_NODES = 1024


def gnn_shapes() -> dict[str, ShapeDef]:
    h1 = BATCH_NODES * FANOUT[0]
    h2 = h1 * FANOUT[1]
    return {
        "full_graph_sm": ShapeDef(
            "full_graph_sm", "train",
            {"n": 2708, "e_dir": 2 * 10556, "f": 1433},
        ),
        "minibatch_lg": ShapeDef(
            "minibatch_lg", "train",
            {
                "n": BATCH_NODES + h1 + h2, "e_dir": h1 + h2, "f": 602,
                "seeds": BATCH_NODES, "fanout": FANOUT,
            },
        ),
        "ogb_products": ShapeDef(
            "ogb_products", "train",
            {"n": 2449029, "e_dir": 2 * 61859140, "f": 100},
        ),
        "molecule": ShapeDef(
            "molecule", "train",
            {"n": 128 * 30, "e_dir": 128 * 2 * 64, "f": 16, "graphs": 128},
        ),
    }


def gnn_input_specs(arch: str, shape: ShapeDef) -> dict:
    """{input name: (shape, dtype)} of one train step of `arch`."""
    n, e = shape.dims["n"], shape.dims["e_dir"]
    f = shape.dims["f"]
    specs: dict = {
        "edge_src": ((e,), I32),
        "edge_dst": ((e,), I32),
        "edge_mask": ((e,), F32),
        "node_mask": ((n,), F32),
    }
    if arch == "egnn":
        specs |= {"x": ((n, f), F32), "coords": ((n, 3), F32), "target": ((n, 1), F32)}
    elif arch == "meshgraphnet":
        specs |= {"x": ((n, f), F32), "edge_attr": ((e, 4), F32), "target": ((n, 3), F32)}
    elif arch == "schnet":
        n_graphs = shape.dims.get("graphs", 1)
        specs |= {
            "species": ((n,), I32),
            "coords": ((n, 3), F32),
            "graph_id": ((n,), I32),
            "target": ((n_graphs,), F32),
        }
    elif arch == "graphsage":
        specs |= {"x": ((n, f), F32), "labels": ((n,), I32)}
    else:
        raise ValueError(arch)
    return specs


def _f32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.int32))


def gnn_smoke_batch(arch: str, seed: int = 0, n: int = 64, e: int = 256, f: int = 8) -> dict:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    batch: dict = {
        "edge_src": _i32(src),
        "edge_dst": _i32(dst),
        "edge_mask": torch.ones((e,), dtype=F32),
        "node_mask": torch.ones((n,), dtype=F32),
    }
    if arch == "egnn":
        batch |= {
            "x": _f32(rng.standard_normal((n, f))),
            "coords": _f32(rng.standard_normal((n, 3))),
            "target": torch.zeros((n, 1), dtype=F32),
        }
    elif arch == "meshgraphnet":
        batch |= {
            "x": _f32(rng.standard_normal((n, f))),
            "edge_attr": _f32(rng.standard_normal((e, 4))),
            "target": torch.zeros((n, 3), dtype=F32),
        }
    elif arch == "schnet":
        batch |= {
            "species": _i32(rng.integers(0, 8, n)),
            "coords": _f32(rng.standard_normal((n, 3)) * 2),
            "graph_id": _i32(np.repeat(np.arange(4), n // 4)),
            "target": torch.zeros((4,), dtype=F32),
        }
        batch["n_graphs"] = 4
    elif arch == "graphsage":
        batch |= {
            "x": _f32(rng.standard_normal((n, f))),
            "labels": _i32(rng.integers(0, 5, n)),
        }
    return batch
