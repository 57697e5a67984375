"""BuffCut-driven GNN placement: the paper's technique as the placement
service of distributed GNN training (counterpart of
`repro/distributed/gnn_placement.py`).

Partition the training graph into k = n_data_shards blocks with the
streaming partitioner; node rows of block i live on data shard i.  Every
cut edge forces the destination shard to fetch the source feature (halo
gather), so the communication volume per GNN layer is exactly

    bytes_moved = cut_edges * d_feat * bytes_per_el

which is the quantity BuffCut minimizes.  `placement_report` quantifies
the win over random and hash placement.

BuffCut and Fennel run through `repro_torch.api.partition`; `device` sets
the multilevel V-cycle's device (`ml.device`), and the engine stays the
reference's default, `MultilevelConfig().engine == "auto"`: on a card the
host V-cycle with the `ell_histogram` kernel (within the ELL tile caps),
on the CPU the host `sparse` engine.  Both give the same labels.
`Placement.stats` keeps a BuffCut run's `StreamStats` (its runtime and
time in the V-cycle), which the reference's `Placement` drops.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.api import DriverConfig, partition
from repro_torch.configs.buffcut_paper import scaled_config
from repro_torch.core.buffcut import StreamStats
from repro_torch.core.metrics import block_loads, edge_cut
from repro_torch.graphs.csr import CSRGraph


@dataclasses.dataclass
class Placement:
    block: np.ndarray            # node -> data shard
    k: int
    cut_edges: float
    loads: np.ndarray
    stats: StreamStats | None = None  # the BuffCut run's; None for the other methods

    def halo_bytes_per_layer(self, d_feat: int, bytes_per_el: int = 4) -> float:
        """Each cut edge gathers one remote feature row per layer (dedup'd
        per (node, shard) pair would be lower; this is the upper bound the
        edge cut controls)."""
        return float(self.cut_edges) * d_feat * bytes_per_el


def place_graph(
    g: CSRGraph, n_shards: int, *, method: str = "buffcut", seed: int = 0,
    device: str = "cuda",
) -> Placement:
    """Place `g`'s nodes on `n_shards` data shards by `method`: "buffcut"
    (`scaled_config(g.n, k=n_shards)` on `device`), "fennel", "random"
    (seeded by `seed`) or "hash" (node id mod n_shards)."""
    stats = None
    if method == "buffcut":
        bc = scaled_config(g.n, k=n_shards)
        bc = dataclasses.replace(bc, ml=dataclasses.replace(bc.ml, device=device))
        res = partition(g, DriverConfig(driver="buffcut", buffcut=bc))
        block, stats = res.labels, res.stats
    elif method == "fennel":
        block = partition(g, driver="fennel", k=n_shards, device=device).labels
    elif method == "random":
        rng = np.random.default_rng(seed)
        block = rng.integers(0, n_shards, g.n)
    elif method == "hash":
        block = np.arange(g.n) % n_shards
    else:
        raise ValueError(method)
    return Placement(
        block=block,
        k=n_shards,
        cut_edges=edge_cut(g, block),
        loads=block_loads(g, block, n_shards),
        stats=stats,
    )


def placement_report(g: CSRGraph, n_shards: int, d_feat: int, *,
                     device: str = "cuda") -> dict:
    """{method: cut_edges, halo_MB_per_layer, load_imbalance} for the four
    placements, each made on `device`."""
    out = {}
    for method in ("buffcut", "fennel", "random", "hash"):
        p = place_graph(g, n_shards, method=method, device=device)
        out[method] = {
            "cut_edges": p.cut_edges,
            "halo_MB_per_layer": p.halo_bytes_per_layer(d_feat) / 1e6,
            "load_imbalance": float(p.loads.max() / max(p.loads.mean(), 1e-9)),
        }
    return out


def reorder_for_shards(g: CSRGraph, placement: Placement) -> np.ndarray:
    """Permutation putting each shard's nodes contiguous (shard-major), so
    row-sharded device arrays align with the placement."""
    return np.argsort(placement.block, kind="stable").astype(np.int64)
