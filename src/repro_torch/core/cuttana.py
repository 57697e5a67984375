"""Cuttana-style baseline [Hajidehi et al., VLDB'24].

Phase 1: prioritized buffer ranked by the Cuttana Buffer Score (CBS); on
eviction the node is assigned *sequentially* with Fennel (no batch-wise
multilevel: this is exactly what BuffCut improves on).  Phase 2: nodes are
grouped into k' = ratio*k sub-partitions; coarse-grained sub-partition moves
between blocks are applied greedily while they reduce cut and keep balance.

Host numpy, as in the reference.  The rescoring state is `RescoreState` in
graph mode (`_State`: degrees and slices from the resident CSR), and an
assignment rescores buffered neighbours through the same `increase_key`
sequence as the reference's.  As there, a node entering the buffer is not
marked a member, so no assignment rescores a buffered node: CBS ranks by
degree alone (ROADMAP, "Known states of the reference").
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core._deprecation import require_csr, warn_legacy
from repro_torch.core.buffcut import BuffCutConfig, StreamStats
from repro_torch.core.buffer import BucketPQ
from repro_torch.core.fennel import FennelParams, fennel_choose
from repro_torch.core.rescore import RescoreState, weighted_degrees
from repro_torch.core.scores import ScoreSpec, get_score
from repro_torch.graphs.csr import CSRGraph
from repro_torch.graphs.stream import NodeStream


@dataclasses.dataclass
class CuttanaConfig(BuffCutConfig):
    subpart_ratio: int = 16       # k'/k (paper evaluates 16 and 4096)
    refine_passes: int = 2

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.subpart_ratio < 1:
            raise ValueError(
                f"CuttanaConfig.subpart_ratio (k'/k) must be >= 1, got {self.subpart_ratio}"
            )
        if self.refine_passes < 0:
            raise ValueError(
                f"CuttanaConfig.refine_passes must be >= 0, got {self.refine_passes}"
            )


class _State(RescoreState):
    """`RescoreState` in graph mode: weighted degrees and neighbour slices
    come from the resident CSR instead of the stream's retained adjacency."""

    def __init__(self, g: CSRGraph, spec: ScoreSpec, k: int):
        super().__init__(g.n, spec, k)
        self.g = g
        self.deg_w = weighted_degrees(g)

    def _buffered_slice(self, us: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        pos = self.g.slice_indices(us)
        nbr = self.g.indices[pos].astype(np.int64)
        w = self.g.edge_w[pos].astype(np.float64)
        keep = self.member[nbr]
        return nbr[keep], w[keep]


def _bump_assigned(st: _State, pq: BucketPQ, u: int, was_buffered: bool) -> None:
    """Node u became assigned: rescore its buffered neighbours, in
    first-occurrence adjacency order."""
    touched, scores = st.bump_assigned(np.array([u], dtype=np.int64), was_buffered)
    for w_, s in zip(touched.tolist(), scores.tolist()):
        pq.increase_key(w_, s)


def cuttana_partition(
    g: CSRGraph, cfg: CuttanaConfig
) -> tuple[np.ndarray, StreamStats]:
    """Deprecated shim: `repro_torch.api.partition` is the front door."""
    warn_legacy("cuttana_partition(g, cfg)", "partition(g, driver='cuttana', k=...)")
    return _cuttana_partition(g, cfg)


def _cuttana_partition(
    g: CSRGraph, cfg: CuttanaConfig
) -> tuple[np.ndarray, StreamStats]:
    g = require_csr(g, "cuttana")
    spec = get_score("cbs", d_max=float(cfg.d_max))
    p = FennelParams(
        k=cfg.k, n_total=float(g.node_w.astype(np.float64).sum()),
        m_total=g.total_edge_weight(),
        eps=cfg.eps, gamma=cfg.gamma,
    )
    st = _State(g, spec, cfg.k)
    pq = BucketPQ(spec.s_max, cfg.disc_factor)
    block = np.full(g.n, -1, dtype=np.int64)
    loads = np.zeros(cfg.k, dtype=np.float64)
    stats = StreamStats()
    t0 = time.perf_counter()

    def assign(v: int) -> None:
        i = fennel_choose(
            g.neighbors(v), g.neighbor_weights(v), float(g.node_w[v]), block, loads, p
        )
        block[v] = i
        loads[i] += g.node_w[v]
        _bump_assigned(st, pq, v, was_buffered=False)

    for v, nbrs, _nbr_w, _node_w in NodeStream(g):
        if nbrs.size > cfg.d_max:
            assign(v)
            stats.n_hubs += 1
            continue
        pq.insert(v, st.score(v))
        if cfg.collect_stats:
            stats.peak_mem_items = max(stats.peak_mem_items, len(pq))
        if len(pq) >= cfg.buffer_size:
            assign(pq.extract_max())  # sequential assignment on eviction, no batching
    while len(pq) > 0:
        assign(pq.extract_max())

    # ---- phase 2: coarse sub-partition trades
    kp = cfg.subpart_ratio * cfg.k
    sub = _subpartitions(g, block, kp)
    block = _trade_subpartitions(g, block, sub, kp, p, cfg.refine_passes)
    stats.runtime_s = time.perf_counter() - t0
    return block, stats


def _subpartitions(g: CSRGraph, block: np.ndarray, kp: int) -> np.ndarray:
    """Group nodes into kp sub-partitions respecting their block (round-robin
    within block by stream order, Cuttana's contiguous grouping)."""
    sub = np.zeros(g.n, dtype=np.int64)
    k = int(block.max()) + 1
    per_block = max(kp // max(k, 1), 1)
    counters = np.zeros(k, dtype=np.int64)
    size_target = np.maximum(np.bincount(block, minlength=k) // per_block, 1)
    for v in range(g.n):
        b = block[v]
        sub[v] = b * per_block + min(counters[b] // size_target[b], per_block - 1)
        counters[b] += 1
    return sub


def _trade_subpartitions(
    g: CSRGraph,
    block: np.ndarray,
    sub: np.ndarray,
    kp: int,
    p: FennelParams,
    passes: int,
) -> np.ndarray:
    """Move whole sub-partitions between blocks while cut improves."""
    block = block.copy()
    src = np.repeat(np.arange(g.n, dtype=np.int64), np.diff(g.indptr))
    dst = g.indices.astype(np.int64)
    sub_w = np.zeros(kp, dtype=np.float64)
    np.add.at(sub_w, sub, g.node_w.astype(np.float64))
    sub_block = np.full(kp, -1, dtype=np.int64)
    sub_block[sub] = block  # all members share the block by construction
    loads = np.zeros(p.k, dtype=np.float64)
    np.add.at(loads, block, g.node_w.astype(np.float64))
    for _ in range(passes):
        # connectivity of each sub-partition to each block
        conn = np.zeros((kp, p.k), dtype=np.float64)
        np.add.at(conn, (sub[src], block[dst]), g.edge_w.astype(np.float64))
        cur = conn[np.arange(kp), np.clip(sub_block, 0, p.k - 1)]
        best_blk = np.argmax(conn, axis=1)
        gain = conn[np.arange(kp), best_blk] - cur
        order = np.argsort(-gain, kind="stable")
        moved = 0
        for s in order:
            if gain[s] <= 1e-12 or sub_block[s] < 0:
                continue
            tgt = int(best_blk[s])
            if tgt == sub_block[s]:
                continue
            if loads[tgt] + sub_w[s] > p.cap:
                continue
            loads[sub_block[s]] -= sub_w[s]
            loads[tgt] += sub_w[s]
            members = np.nonzero(sub == s)[0]
            block[members] = tgt
            sub_block[s] = tgt
            moved += 1
        if moved == 0:
            break
    return block
