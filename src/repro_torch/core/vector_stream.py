"""Vectorized BuffCut driver — the data-parallel adaptation of Algorithm 1.

The bucket PQ is replaced by dense score vectors and top-`wave` eviction
(DESIGN.md §3, `core/buffer.py::VectorBuffer`): a stream chunk is
inserted, then eviction waves of size `wave` are popped until the buffer
is back under capacity; after each wave the evicted nodes' buffered
neighbors are rescored in one batched adjacency-slice pass.  `chunk=1,
wave=1` reproduces the sequential driver's evictions and labels; larger
values trade fidelity to the paper for fewer, wider host operations.

Like the sequential driver it consumes only the node-stream protocol, and
retains adjacency only while a node is buffered or batched.  Full batches
go through the same V-cycle (`multilevel_partition`, on `cfg.ml.device`
for the device engines), with no host fallback.  The buffer stays on the
host, as in the reference's driver.

`score_kernel` is the dense scoring function as torch tensor operations,
the counterpart of the reference's jitted `score_kernel`; no driver calls
it.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import TYPE_CHECKING

import numpy as np

from repro_torch.core.batch_model import build_batch_model_from_adj
from repro_torch.core._deprecation import warn_legacy
from repro_torch.core.buffcut import BuffCutConfig, StreamStats
from repro_torch.core.buffer import VectorBuffer
from repro_torch.core.checkpoint import (
    Checkpointer,
    ResumeBase,
    pack_rescore,
    pack_vector_buffer,
    restore_run,
    unpack_vector_buffer,
)
from repro_torch.core.fennel import FennelParams, fennel_choose
from repro_torch.core.metrics import internal_edge_ratio_adj, streaming_cut_increment
from repro_torch.core.multilevel import multilevel_partition
from repro_torch.core.prefetch import PrefetchStream, maybe_prefetch
from repro_torch.core.rescore import RescoreState
from repro_torch.device import preflight
from repro_torch.graphs.csr import CSRGraph
from repro_torch.graphs.stream import NodeStreamBase, as_node_stream

if TYPE_CHECKING:
    import torch


def score_kernel(
    assigned_w: torch.Tensor,
    deg_w: torch.Tensor,
    buffered_w: torch.Tensor,
    *,
    kind: str = "haa",
    d_max: float = 10000.0,
    beta: float = 2.0,
    theta: float = 0.75,
    eta: float = 0.5,
) -> torch.Tensor:
    """Dense buffer scores for every node, on the tensors' device; the
    formulas of `core.scores.ScoreSpec.__call__` (anr/cbs/haa/nss)."""
    import torch  # deferred: no driver calls this, so the driver never imports torch

    d_safe = torch.clamp(deg_w, min=1.0)
    anr = assigned_w / d_safe
    if kind == "anr":
        return anr
    if kind == "cbs":
        return deg_w / d_max + theta * anr
    if kind == "haa":
        dn = deg_w / d_max
        return dn**beta + theta * (1.0 - dn) * anr
    if kind == "nss":
        return (assigned_w + eta * buffered_w) / d_safe
    raise ValueError(f"vectorized driver supports anr/cbs/haa/nss, got {kind}")


@dataclasses.dataclass
class VectorizedConfig:
    """Knobs of the vectorized driver: wave=1, chunk=1 reproduces the
    sequential driver bit-exactly (DESIGN.md §3.2)."""

    wave: int = 1                # eviction wave size (top-`wave` pops)
    chunk: int = 1               # stream arrival chunk size
    engine: str = "incremental"  # VectorBuffer engine: "incremental" | "scan"

    def __post_init__(self) -> None:
        if self.wave < 1:
            raise ValueError(f"VectorizedConfig.wave must be >= 1, got {self.wave}")
        if self.chunk < 1:
            raise ValueError(f"VectorizedConfig.chunk must be >= 1, got {self.chunk}")
        if self.engine not in ("incremental", "scan"):
            raise ValueError(
                f"unknown VectorBuffer engine {self.engine!r}: pick "
                "'incremental' (O(occ) per wave) or 'scan' (the oracle)"
            )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "VectorizedConfig":
        return cls(**d)


def buffcut_partition_vectorized(
    g: CSRGraph | NodeStreamBase,
    cfg: BuffCutConfig,
    vec: VectorizedConfig | None = None,
    *,
    prefetch_batches: int = 0,
    ckpt: Checkpointer | None = None,
    resume: dict | None = None,
) -> tuple[np.ndarray, StreamStats]:
    """Deprecated shim: `repro_torch.api.partition` is the front door.

    Partitions a node stream into `cfg.k` blocks with the dense buffer;
    returns (block, stats).  CMS is refused (it needs per-block counts).

    `ckpt` snapshots at chunk boundaries, `resume` continues from such a
    snapshot bit-identically (`core/checkpoint.py`); both need the
    `incremental` VectorBuffer engine, whose compact arrays are what a
    snapshot holds.  wave, chunk and engine change labels, so they are part
    of the snapshot's identity beside the BuffCut config.
    """
    warn_legacy(
        "buffcut_partition_vectorized(g, cfg, vec)",
        "partition(g, driver='buffcut-vec', k=..., wave=..., chunk=..., vec_engine=...)",
    )
    if cfg.ml.engine != "sparse":
        preflight(cfg.ml.device)
    return _buffcut_partition_vectorized(g, cfg, vec, prefetch_batches=prefetch_batches,
                                         ckpt=ckpt, resume=resume)


def _buffcut_partition_vectorized(
    g: CSRGraph | NodeStreamBase,
    cfg: BuffCutConfig,
    vec: VectorizedConfig | None = None,
    *,
    prefetch_batches: int = 0,
    ckpt: Checkpointer | None = None,
    resume: dict | None = None,
) -> tuple[np.ndarray, StreamStats]:
    """`buffcut_partition_vectorized` without `preflight` or the deprecation
    warning: the API enters here after it checked the device once."""
    vec = vec if vec is not None else VectorizedConfig()
    if cfg.score_spec().needs_block_counts:
        raise ValueError("CMS needs per-block counts; use the sequential driver")
    if (ckpt is not None or resume is not None) and vec.engine != "incremental":
        raise ValueError(
            f"checkpoint/resume needs the 'incremental' VectorBuffer engine, got {vec.engine!r}"
        )
    # background read-ahead: record order — and so labels — unchanged
    stream = maybe_prefetch(as_node_stream(g), prefetch_batches, cfg.batch_size)
    try:
        return _run(stream, cfg, vec, ckpt, resume)
    finally:
        if isinstance(stream, PrefetchStream):
            stream.close()


def _run(stream: NodeStreamBase, cfg: BuffCutConfig, vec: VectorizedConfig,
         ckpt: Checkpointer | None, resume: dict | None) -> tuple[np.ndarray, StreamStats]:
    wave, chunk = vec.wave, vec.chunk
    spec = cfg.score_spec()
    n = stream.n
    p = FennelParams(k=cfg.k, n_total=stream.n_total, m_total=stream.m_total,
                     eps=cfg.eps, gamma=cfg.gamma)
    buf = VectorBuffer(n, spec.s_max, cfg.disc_factor, engine=vec.engine)
    # the rescore state shares the buffer's membership mask zero-copy
    st = RescoreState(n, spec, cfg.k, member=buf.in_buf)
    block = np.full(n, -1, dtype=np.int64)
    loads = np.zeros(cfg.k, dtype=np.float64)
    batch: list[np.ndarray] = []
    batch_count = 0
    stats = StreamStats()
    config_json = json.dumps({"cfg": cfg.to_dict(), "vec": vec.to_dict()}, sort_keys=True)
    if resume is not None:
        # rescore first, buffer second: unpack_vector_buffer rewrites the
        # in_buf mask that restore_run restored through st.member
        stats = restore_run(resume, "buffcut-vec", config_json, n, block, loads, st, ckpt,
                            StreamStats.from_dict)
        unpack_vector_buffer(buf, resume["buf"])
        pend_b = np.asarray(resume["batch"], dtype=np.int64)
        if pend_b.size:
            batch.append(pend_b)
            batch_count = int(pend_b.size)
    base = ResumeBase(stats)

    def make_state() -> dict:
        sd = base.snapshot_stats(stats, stream, ckpt)
        return {
            "kind": "buffcut-vec",
            "config_json": config_json,
            "n": n,
            "pos": stream.tell(),
            "block": block,
            "loads": loads,
            "batch": (np.concatenate(batch)[:batch_count] if batch
                      else np.empty(0, dtype=np.int64)),
            "stats": sd,
            "state": pack_rescore(st),
            "buf": pack_vector_buffer(buf),
        }

    def note_peak(extra: int = 0) -> None:
        resident = st.adj.resident_bytes + stream.resident_bytes + extra
        if resident > stats.peak_resident_bytes:
            stats.peak_resident_bytes = resident

    def rescore_neighbors_of(us: np.ndarray, was_buffered: bool) -> None:
        """Admitted/assigned wave `us`: one batched adjacency-slice rescore."""
        touched, scores = st.bump_assigned(us, was_buffered)
        if touched.size:
            buf.update_scores(touched, scores)

    def commit_batch() -> None:
        nonlocal batch_count
        if batch_count == 0:
            return
        bnodes = np.concatenate(batch)[:batch_count]
        nbr_c, w_c, degs = st.adj.slice(bnodes)
        node_w_b = st.adj.node_weights(bnodes)
        model = build_batch_model_from_adj(n, bnodes, degs, nbr_c, w_c, node_w_b, block, cfg.k)
        t_ml = time.perf_counter()
        labels = multilevel_partition(model.graph, model.pinned_block, p, loads, cfg.ml)
        stats.ml_time_s += time.perf_counter() - t_ml
        lab_b = labels[: bnodes.shape[0]]
        block[bnodes] = lab_b
        np.add.at(loads, lab_b, node_w_b.astype(np.float64))
        stats.cut_weight += streaming_cut_increment(bnodes, lab_b, degs, nbr_c, w_c, block)
        note_peak(model.graph.indices.nbytes + model.graph.edge_w.nbytes)
        stats.n_batches += 1
        if cfg.collect_stats:
            stats.ier_per_batch.append(internal_edge_ratio_adj(bnodes, nbr_c, w_c, n))
        st.release(bnodes)
        batch.clear()
        batch_count = 0

    def admit(us: np.ndarray) -> None:
        nonlocal batch_count
        while us.size:
            room = cfg.batch_size - batch_count
            take, us = us[:room], us[room:]
            batch.append(take)
            batch_count += take.size
            if cfg.collect_stats:
                stats.evictions.extend(take.tolist())
            rescore_neighbors_of(take, was_buffered=True)
            if batch_count == cfg.batch_size:
                commit_batch()

    def process_chunk(records: list[tuple[int, np.ndarray, np.ndarray, float]]) -> None:
        for v, nbrs, wts, node_w in records:
            st.observe(v, nbrs, wts, node_w)
        note_peak()
        degs = np.array([r[1].size for r in records], dtype=np.int64)
        vs = np.array([r[0] for r in records], dtype=np.int64)
        hub_mask = degs > cfg.d_max
        for idx in np.nonzero(hub_mask)[0]:
            # hubs are rare; the sequential Fennel decision is exact and cheap
            h, nbrs, wts, node_w = records[idx]
            i = fennel_choose(nbrs, wts, float(node_w), block, loads, p)
            block[h] = i
            loads[i] += np.float32(node_w)
            stats.n_hubs += 1
            hv = np.array([h], dtype=np.int64)
            hnbr, hw, hdeg = st.adj.slice(hv)
            stats.cut_weight += streaming_cut_increment(
                hv, np.array([i], dtype=np.int64), hdeg, hnbr, hw, block)
            rescore_neighbors_of(hv, was_buffered=False)
            st.release(hv)
        rest = vs[~hub_mask]
        if rest.size:
            if spec.needs_buffered_count:
                # mutual buffered counts for the arriving chunk; edges between
                # chunk-mates are not credited (membership is checked before
                # the chunk inserts), so chunk > 1 under-counts NSS — exact
                # for chunk=1, the paper's semantics
                touched, scores = st.bump_buffered(rest)
                if touched.size:
                    buf.update_scores(touched, scores)
            buf.insert_many(rest, st.scores_of(rest))
        while len(buf) >= cfg.buffer_size:
            admit(buf.evict(min(wave, len(buf) - cfg.buffer_size + 1)))

    pending: list[tuple[int, np.ndarray, np.ndarray, float]] = []
    records = stream.iter_from(dict(resume["pos"])) if resume is not None else iter(stream)
    for rec in records:
        pending.append(rec)
        if len(pending) == chunk:
            process_chunk(pending)
            pending = []
            # chunk boundary: snapshots fire only here, so a resumed run
            # groups the remaining records into the same chunks
            if ckpt is not None:
                ckpt.maybe_save(stats.n_batches, make_state)
    if pending:
        process_chunk(pending)
    while len(buf) > 0:
        admit(buf.evict(min(wave, len(buf))))
    commit_batch()
    stats.balance = float(loads.max() / (p.n_total / cfg.k)) if p.n_total > 0 else 1.0
    stats.block_loads = loads.tolist()
    base.fold(stats, stream, ckpt)
    return block, stats
