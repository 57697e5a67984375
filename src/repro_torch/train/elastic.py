"""Elastic rescaling: move a checkpointed state onto another mesh
(counterpart of `repro/train/elastic.py`).

Checkpoints are host numpy (mesh-agnostic); rescaling rebuilds the
placements for the new mesh from the same logical rules and places every
leaf with `distribute_tensor`.  Shrink (2x16x16 -> 16x16) and grow both
work.  This is also how a state of the JAX package, as numpy arrays,
reaches a mesh in the port.  Batch-size invariance across a rescale is the
data pipeline's job (global batch fixed, per-shard batch = global /
data-parallel degree).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import distribute_tensor

from repro_torch.distributed.sharding import ShardingRules, param_shardings
from repro_torch.launch.mesh import dp_size
from repro_torch.tree import tree_map


def _to_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V" or str(arr.dtype) == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def reshard_state(state, rules: ShardingRules, new_mesh: DeviceMesh):
    """`state`: a host tree (numpy arrays or CPU tensors, as a checkpoint
    restores it), the same on every rank.  Returns the same tree of
    DTensors on `new_mesh` under `rules`; each rank keeps its own block
    of the host array (no data moves between ranks)."""
    shardings = param_shardings(rules, new_mesh, state)
    device = new_mesh.device_type

    def place(leaf, sharding):
        t = _to_tensor(leaf).to(device)
        return distribute_tensor(t, new_mesh, sharding.placements(tuple(t.shape)),
                                 src_data_rank=None)

    return tree_map(place, state, shardings)


def dp_degree(mesh: DeviceMesh) -> int:
    return dp_size(mesh)


def per_shard_batch(global_batch: int, mesh: DeviceMesh) -> int:
    dp = dp_degree(mesh)
    assert global_batch % dp == 0, (global_batch, dp)
    return global_batch // dp
