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


def halo_batch(g: CSRGraph, block: np.ndarray, n_shards: int, x: np.ndarray,
               labels: np.ndarray) -> dict:
    """The inputs of `models/gnn.py::sage_fullgraph_halo_loss` for `g`
    placed by `block` (k blocks) on `n_shards` data-parallel ranks, as
    whole numpy arrays in shard-major order (each rank's rows a contiguous,
    equal-sized block).

    Blocks go to shards in contiguous ranges (block b on shard
    b * n_shards // k) and nodes keep their id order within a block.  A
    node with a neighbour in another block is a frontier node: its shard
    contributes its row to the frontier, and every edge that crosses
    blocks, on one shard or across two, reads its source from the
    frontier slot, so the frontier is what the placement's cut bounds.
    Each undirected edge {u, v} is two messages, u -> v and v -> u, held by
    the destination's shard.  Shards are padded to equal node, frontier and
    edge counts (node_mask / edge_mask 0; padded frontier slots hold row 0
    and no edge reads them).

    Returns x, labels, node_mask, frontier_own, edge_src, edge_dst,
    edge_mask, plus `node` (the graph node of each row, -1 for padding) and
    `n_shards`."""
    n = g.n
    block = np.asarray(block, dtype=np.int64)
    k = int(block.max()) + 1
    shard = block * n_shards // k
    order = np.lexsort((np.arange(n), block, shard))
    counts = np.bincount(shard, minlength=n_shards)
    n_loc = max(int(counts.max()), 1)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    row = np.empty(n, dtype=np.int64)            # node -> local row on its shard
    row[order] = np.arange(n) - first[shard[order]]

    src = np.repeat(np.arange(n), np.diff(g.indptr))      # message src -> dst
    dst = g.indices.astype(np.int64)
    cross = block[src] != block[dst]
    is_front = np.zeros(n, dtype=bool)
    is_front[src[cross]] = True
    front_nodes = order[is_front[order]]                  # shard-major, then block, id
    f_counts = np.bincount(shard[front_nodes], minlength=n_shards)
    hf_loc = max(int(f_counts.max()), 1)
    f_first = np.concatenate([[0], np.cumsum(f_counts)[:-1]])
    slot = np.full(n, -1, dtype=np.int64)                 # node -> global frontier slot
    f_shard = shard[front_nodes]
    slot[front_nodes] = f_shard * hf_loc + np.arange(len(front_nodes)) - f_first[f_shard]

    e_shard = shard[dst]
    e_order = np.lexsort((src, dst, e_shard))             # by shard, then dst, then src
    e_counts = np.bincount(e_shard, minlength=n_shards)
    e_loc = max(int(e_counts.max()), 1)
    e_first = np.concatenate([[0], np.cumsum(e_counts)[:-1]])

    f_dim = x.shape[1]
    out = {
        "x": np.zeros((n_shards * n_loc, f_dim), dtype=np.float32),
        "labels": np.zeros(n_shards * n_loc, dtype=np.int32),
        "node_mask": np.zeros(n_shards * n_loc, dtype=np.float32),
        "node": np.full(n_shards * n_loc, -1, dtype=np.int64),
        "frontier_own": np.zeros(n_shards * hf_loc, dtype=np.int32),
        "edge_src": np.zeros(n_shards * e_loc, dtype=np.int32),
        "edge_dst": np.zeros(n_shards * e_loc, dtype=np.int32),
        "edge_mask": np.zeros(n_shards * e_loc, dtype=np.float32),
        "n_shards": n_shards,
    }
    g_row = shard * n_loc + row
    out["x"][g_row] = x
    out["labels"][g_row] = labels
    out["node_mask"][g_row] = 1.0
    out["node"][g_row] = np.arange(n)
    out["frontier_own"][slot[front_nodes]] = row[front_nodes]
    es, ed = src[e_order], dst[e_order]
    pos = e_shard[e_order] * e_loc + np.arange(len(e_order)) - e_first[e_shard[e_order]]
    via = block[es] != block[ed]
    out["edge_src"][pos] = np.where(via, n_loc + slot[es], row[es])
    out["edge_dst"][pos] = row[ed]
    out["edge_mask"][pos] = 1.0
    return out


def assemble_halo_batch(hb: dict) -> dict:
    """A `halo_batch` as one whole-graph batch for `sage_loss`, in its row
    space (shard s's local row r is row s * N_loc + r): each frontier
    slot's edges read the row that owns the slot."""
    p = hb["n_shards"]
    n_loc = hb["x"].shape[0] // p
    hf_loc = hb["frontier_own"].shape[0] // p
    e_loc = hb["edge_src"].shape[0] // p
    owner = (np.arange(p * hf_loc) // hf_loc) * n_loc + hb["frontier_own"]
    e_sh = np.arange(p * e_loc) // e_loc
    src = hb["edge_src"].astype(np.int64)
    g_src = np.where(src < n_loc, e_sh * n_loc + src, owner[np.clip(src - n_loc, 0, None)])
    return {
        "x": hb["x"], "labels": hb["labels"], "node_mask": hb["node_mask"],
        "edge_src": g_src.astype(np.int32),
        "edge_dst": (e_sh * n_loc + hb["edge_dst"]).astype(np.int32),
        "edge_mask": hb["edge_mask"],
    }
