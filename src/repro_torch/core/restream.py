"""Restreaming refinement (paper §3.5) — stream-native.

Pass 1 is any partitioner.  Later passes replay the *stream* — in-memory
`NodeStream` or disk-backed `DiskNodeStream`, METIS text or packed binary —
in bounded δ-batches and re-partition each batch jointly against the fixed
global assignment, exactly the way the three first-pass drivers commit
batches: adjacency is retained only for the current batch (plus, in
priority mode, the bounded buffer) in a `rescore.AdjacencyCache`, the batch
model comes from `build_batch_model_from_adj`, and the full graph is never
materialized.  Resident state beyond the stream's read-ahead window is the
global label array (O(n)), the per-block float64 loads (O(k)), and that
retained adjacency (DESIGN.md §4, "Restream substrate").

Replay orders (`restream_order`):

* ``"stream"`` — contiguous δ-batches in stream order: the paper's
  restreaming rows (Table 2), where later passes skip buffering entirely.
* ``"priority"`` — gain-prioritized replay in the spirit of prioritized
  restreaming (Awadelkarim & Ugander, arXiv:2007.03131): a bounded buffer
  of up to Q_max arrivals holds *streamed gain estimates* (weight to the
  best-connected block minus weight to the current block, from the record's
  adjacency and the live labels); when full, the δ highest-gain nodes are
  evicted as one batch, so the nodes with the most to gain are re-decided
  first while their estimates are freshest.

In both orders, hub rows (deg > d_max) bypass the batch/buffer and are
re-assigned immediately via Fennel — the same Alg. 1 bypass the first pass
uses — so the residency bound never depends on hub degrees.

The exact edge cut is maintained incrementally across every reassignment
(`metrics.IncrementalCut`): each batch is staged under its old labels and
committed under its new ones, with the delta computed from the batch's
retained adjacency only — no full-graph recompute between passes, and the
final `RestreamInfo.cut_weight` matches an offline `edge_cut` on the
refined labels.

Every δ-batch goes through `multilevel_partition` on `cfg.ml.device` (the
device V-cycle for engine "torch").  Unlike the reference there is no host
fallback, so the pass log has no `engine_fallbacks` count: a device error
propagates to the caller.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

from repro_torch.core.batch_model import build_batch_model_from_adj
from repro_torch.core.buffcut import BuffCutConfig
from repro_torch.core.checkpoint import (
    Checkpointer,
    check_resume,
    pack_adjacency,
    unpack_adjacency,
)
from repro_torch.core.fennel import FennelParams, block_connectivity, fennel_choose
from repro_torch.core.metrics import IncrementalCut
from repro_torch.core.multilevel import multilevel_partition
from repro_torch.core.prefetch import PrefetchStream, maybe_prefetch
from repro_torch.core.rescore import AdjacencyCache
from repro_torch.device import preflight
from repro_torch.graphs.csr import CSRGraph
from repro_torch.graphs.stream import NodeStream, NodeStreamBase, as_node_stream

RESTREAM_ORDERS = ("stream", "priority")


@dataclasses.dataclass
class RestreamInfo:
    """What a `restream_refine` call measured: the refreshed quality fields
    the caller folds back into `StreamStats`, the canonical totals the
    Fennel params were built from (parity-pinned against the first pass),
    and a per-pass provenance log."""

    cut_weight: float = 0.0
    balance: float = 0.0
    n_total: float = 0.0
    m_total: float = 0.0
    order: str = "stream"
    passes: list = dataclasses.field(default_factory=list)  # per-pass dicts
    peak_resident_bytes: int = 0
    stream_bytes_read: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _check_replay(stream: NodeStreamBase, seen: int, where: str = "") -> None:
    """A replay that comes up short means the source is exhausted (one-shot
    foreign stream) or truncated — fail loudly, never refine silently.

    The two causes get distinct diagnoses: zero records is a source that
    cannot replay at all; a partial replay is a stream that was truncated
    mid-pass (disk file shrank under us), reported with the byte offset the
    stream stopped at and which pass lost data.
    """
    if seen == stream.n:
        return
    if seen == 0:
        raise ValueError(
            f"stream replay{where} yielded 0 of {stream.n} records: the "
            "source is not replayable (one-shot stream?). Restream needs a "
            "CSRGraph, a NodeStream, or a disk-backed stream; materialize "
            "one-shot streams first."
        )
    at = ""
    try:
        pos = stream.tell()
    except NotImplementedError:
        pos = None
    if pos is not None:
        off = pos.get("offset")
        at = (f" at byte offset {off}" if off is not None
              else f" at record index {pos.get('index')}")
    raise ValueError(
        f"stream replay{where} yielded only {seen} of {stream.n} records{at}: "
        "the stream was truncated mid-pass — the backing file shrank or the "
        "source stops replaying part-way (not replayable end-to-end). "
        "Refusing to refine against partial data."
    )


def _replay_totals(
    stream: NodeStreamBase, block: np.ndarray, k: int, need_cut: bool
) -> tuple[np.ndarray, float, int]:
    """One bounded-memory prelude pass: per-block loads (float64,
    accumulated in id order so every stream backend agrees bit-exactly)
    and — when the caller has no driver-streamed cut to hand over — the
    exact starting edge cut, each undirected edge charged once at its
    higher-id endpoint (self-loops are never cut)."""
    loads = np.zeros(k, dtype=np.float64)
    if isinstance(stream, NodeStream) and not need_cut:
        # graph-backed fast path: np.add.at accumulates element-by-element
        # in id order — bit-identical to the per-record loop below, without
        # a python-level replay of the whole stream
        np.add.at(loads, block, stream._g.node_w.astype(np.float64))
        return loads, 0.0, 0
    cut = 0.0
    peak = 0
    seen = 0
    for v, nbrs, w, node_w in stream:
        loads[block[v]] += float(node_w)
        if need_cut and nbrs.size:
            nb = nbrs.astype(np.int64)
            cross = (nb < v) & (block[nb] != block[v])
            if cross.any():
                cut += float(np.sum(w[cross].astype(np.float64)))
        if stream.resident_bytes > peak:
            peak = stream.resident_bytes
        seen += 1
    _check_replay(stream, seen, " during the loads/cut prelude")
    return loads, cut, peak


def _move_gain(v: int, nbrs: np.ndarray, w: np.ndarray, block: np.ndarray, k: int) -> float:
    """Streamed gain estimate: weight to the best-connected block minus
    weight to the current block (>= 0; 0 when v already sits best)."""
    if nbrs.size == 0:
        return 0.0
    conn = block_connectivity(nbrs.astype(np.int64), w, block, k)
    return float(conn.max() - conn[block[v]])


class MicroRestreamer:
    """The reusable δ-batch re-assignment core — factored out of the
    restream pass loop so a serving loop can drain its standing priority
    buffer through the *same* machinery.

    Owns no stream and no replay policy.  Callers retain each node's
    adjacency in `adj` (a `rescore.AdjacencyCache`) and hand over batches;
    `commit` re-decides a δ-batch jointly through the batch-multilevel
    engine while `commit_hub` re-assigns one hub row (deg > d_max)
    immediately via Fennel — both keep the global label array, the
    per-block float64 loads, and the exact incremental cut
    (`metrics.IncrementalCut` stage/commit bracket) consistent in place,
    and release the batch's adjacency afterwards.

    Counters accumulate into the caller-supplied `log` dict under the
    restream pass-log keys (``n_batches``/``n_hubs``/``moved``) so checkpointed pass logs and the service's
    refine summaries share one schema.  `on_peak(extra_bytes)` fires at
    every batch's residency high-water mark; `on_commit()` after every
    committed batch (the restream checkpoint cadence hook).
    """

    def __init__(
        self,
        n: int,
        block: np.ndarray,
        loads: np.ndarray,
        cm: IncrementalCut,
        cfg: BuffCutConfig,
        params: FennelParams,
        adj: AdjacencyCache,
        *,
        log: "dict | None" = None,
        on_peak=None,
        on_commit=None,
    ):
        self.n = int(n)
        self.block = block
        self.loads = loads
        self.cm = cm
        self.cfg = cfg
        self.p = params
        self.adj = adj
        self.log = log if log is not None else {"n_batches": 0, "n_hubs": 0, "moved": 0}
        self._on_peak = on_peak
        self._on_commit = on_commit
        self._one = np.empty(1, dtype=np.int64)

    def commit(self, bnodes: np.ndarray) -> np.ndarray:
        """Jointly re-partition `bnodes` against the fixed outside labels:
        stage the old cut contribution, detach the batch (loads released,
        labels hidden from the model), run the batch-multilevel assignment,
        write back, and fold the exact cut delta in.  Returns the new
        labels in batch order."""
        nbr_c, w_c, degs = self.adj.slice(bnodes)
        node_w_b = self.adj.node_weights(bnodes)
        old = self.block[bnodes].copy()
        self.cm.stage(bnodes, degs, nbr_c, w_c, self.block)
        # detach the batch: release loads, hide current labels from the model
        np.add.at(self.loads, old, -node_w_b.astype(np.float64))
        self.block[bnodes] = -1
        model = build_batch_model_from_adj(
            self.n, bnodes, degs, nbr_c, w_c, node_w_b, self.block, self.cfg.k
        )
        labels = multilevel_partition(
            model.graph, model.pinned_block, self.p, self.loads, self.cfg.ml
        )
        new = labels[: bnodes.shape[0]]
        self.block[bnodes] = new
        np.add.at(self.loads, new, node_w_b.astype(np.float64))
        self.cm.commit(bnodes, new, degs, nbr_c, w_c, self.block)
        if self._on_peak is not None:
            self._on_peak(model.graph.indices.nbytes + model.graph.edge_w.nbytes)
        self.log["n_batches"] += 1
        self.log["moved"] += int(np.count_nonzero(new != old))
        self.adj.drop(bnodes)
        if self._on_commit is not None:
            self._on_commit()
        return new

    def commit_hub(self, v: int, node_w: float) -> int:
        """Hub bypass (Alg. 1): immediate Fennel re-assignment keeps the
        batch residency bound independent of hub degrees.  Returns the
        block `v` landed in."""
        one = self._one
        one[0] = v
        nbr_c, w_c, degs = self.adj.slice(one)
        self.cm.stage(one, degs, nbr_c, w_c, self.block)
        old_b = int(self.block[v])
        self.loads[old_b] -= float(node_w)
        self.block[v] = -1
        i = fennel_choose(nbr_c, w_c, float(node_w), self.block, self.loads, self.p)
        self.block[v] = i
        self.loads[i] += float(node_w)
        self.cm.commit(one, np.asarray([i], dtype=np.int64), degs, nbr_c, w_c, self.block)
        self.log["n_hubs"] += 1
        self.log["moved"] += int(i != old_b)
        self.adj.drop(one)
        return i


def restream_refine(
    source: "CSRGraph | NodeStreamBase",
    block: np.ndarray,
    cfg: BuffCutConfig,
    passes: int,
    *,
    order: str = "stream",
    initial_cut: "float | None" = None,
    initial_loads: "np.ndarray | None" = None,
    prefetch_batches: int = 0,
    ckpt: "Checkpointer | None" = None,
    resume: "dict | None" = None,
) -> tuple[np.ndarray, RestreamInfo]:
    """Apply `passes` restreaming passes over any replayable stream source.

    `initial_cut` seeds the incremental maintainer with a known-exact cut
    (the driver's streamed `StreamStats.cut_weight`) and `initial_loads`
    with the driver's final per-block loads (`StreamStats.block_loads`);
    with both supplied the prelude replay is skipped entirely — each
    restream pass then costs exactly one stream read.  Without them the
    prelude pass computes both.  Returns the refined labels and the
    `RestreamInfo` bookkeeping (refreshed cut/balance, canonical totals,
    per-pass log, measured peak residency).

    `ckpt` snapshots at batch boundaries (kind "restream", counter
    cumulative across passes so the cadence spans pass borders); `resume`
    restarts mid-pass from such a snapshot — labels, loads, the incremental
    cut total, completed-pass logs, the retained adjacency, and the
    pending/priority buffers all restored, then the stream reopens at the
    recorded byte offset.  The refined labels are bit-identical to the
    uninterrupted run; the prelude and `initial_*` seeds are skipped
    because their outcome is already baked into the snapshot.
    """
    if order not in RESTREAM_ORDERS:
        raise ValueError(
            f"unknown restream order {order!r}: pick one of {RESTREAM_ORDERS}"
        )
    if passes < 0:
        raise ValueError(f"restream passes must be >= 0, got {passes}")
    if cfg.ml.engine != "sparse":
        preflight(cfg.ml.device)
    # every replay pass reads through the same prefetcher (parse overlaps
    # the re-partitioning); record order — and labels — are unchanged
    stream = maybe_prefetch(as_node_stream(source), prefetch_batches, cfg.batch_size)
    try:
        return _refine(stream, block, cfg, passes, order, initial_cut, initial_loads,
                       ckpt, resume)
    finally:
        if isinstance(stream, PrefetchStream):
            stream.close()  # joins the pump on every exit path


def _refine(
    stream: NodeStreamBase,
    block: np.ndarray,
    cfg: BuffCutConfig,
    passes: int,
    order: str,
    initial_cut: "float | None",
    initial_loads: "np.ndarray | None",
    ckpt: "Checkpointer | None",
    resume: "dict | None",
) -> tuple[np.ndarray, RestreamInfo]:
    block = np.asarray(block, dtype=np.int64).copy()
    if block.shape[0] != stream.n:
        raise ValueError(
            f"label array has {block.shape[0]} entries, stream has {stream.n} nodes"
        )
    if block.size and ((block < 0).any() or (block >= cfg.k).any()):
        raise ValueError(
            "restream needs a complete first-pass assignment: every label in "
            f"[0, {cfg.k})"
        )
    # canonical totals (graphs/stream.py): the restream FennelParams are
    # bit-identical to the first-pass params on every stream backend
    p = FennelParams(
        k=cfg.k, n_total=stream.n_total, m_total=stream.m_total,
        eps=cfg.eps, gamma=cfg.gamma,
    )
    info = RestreamInfo(order=order, n_total=p.n_total, m_total=p.m_total)
    bytes0 = stream.bytes_read
    bytes_base = 0
    # order and total pass count shape the label trajectory, so both are
    # part of the resume identity alongside the BuffCut config
    config_json = json.dumps(
        {"cfg": cfg.to_dict(), "order": order, "passes": passes}, sort_keys=True
    )
    total_batches = [0]  # cumulative across passes: the checkpoint cadence
    start_pass = 0
    if resume is not None:
        check_resume(resume, "restream", config_json, stream.n)
        block[:] = resume["block"]
        loads = np.asarray(resume["loads"], dtype=np.float64)
        cm = IncrementalCut(float(resume["cut_weight"]))
        info.passes = list(resume["passes"])
        info.peak_resident_bytes = int(resume["peak_resident_bytes"])
        bytes_base = int(resume["stream_bytes_read"])
        total_batches[0] = int(resume["total_batches"])
        start_pass = int(resume["pass_idx"])
        if ckpt is not None:
            ckpt.mark(total_batches[0])
    elif initial_loads is not None and initial_cut is not None:
        loads = np.asarray(initial_loads, dtype=np.float64).copy()
        if loads.shape[0] != cfg.k:
            raise ValueError(
                f"initial_loads has {loads.shape[0]} blocks, config has k={cfg.k}"
            )
        cm = IncrementalCut(initial_cut)
    else:
        loads, cut0, peak0 = _replay_totals(
            stream, block, cfg.k, need_cut=initial_cut is None
        )
        info.peak_resident_bytes = peak0
        if initial_cut is None:
            initial_cut = cut0
        cm = IncrementalCut(initial_cut)
    for pi in range(start_pass, passes):
        pass_resume = resume if (resume is not None and pi == start_pass) else None
        cut_before = (float(resume["cut_before"]) if pass_resume is not None
                      else cm.cut_weight)
        log = _restream_pass_impl(
            stream, block, loads, cm, cfg, p, order, info,
            pass_idx=pi, config_json=config_json, total_batches=total_batches,
            ckpt=ckpt, cut_before=cut_before, bytes_base=bytes_base,
            bytes0=bytes0, resume=pass_resume,
        )
        log["cut_before"] = cut_before
        log["cut_after"] = cm.cut_weight
        info.passes.append(log)
    info.cut_weight = cm.cut_weight
    info.balance = float(loads.max() / (p.n_total / cfg.k)) if p.n_total > 0 else 1.0
    info.stream_bytes_read = bytes_base + (stream.bytes_read - bytes0)
    return block, info


def _restream_pass_impl(
    stream: NodeStreamBase,
    block: np.ndarray,
    loads: np.ndarray,
    cm: IncrementalCut,
    cfg: BuffCutConfig,
    p: FennelParams,
    order: str,
    info: RestreamInfo,
    *,
    pass_idx: int = 0,
    config_json: str = "",
    total_batches: "list[int] | None" = None,
    ckpt: "Checkpointer | None" = None,
    cut_before: float = 0.0,
    bytes_base: int = 0,
    bytes0: int = 0,
    resume: "dict | None" = None,
) -> dict:
    n = stream.n
    adj = AdjacencyCache()
    log = {"order": order, "n_batches": 0, "n_hubs": 0, "moved": 0}
    if total_batches is None:
        total_batches = [0]
    seen = 0
    if resume is not None:
        log = dict(resume["log"])
        unpack_adjacency(adj, resume["adj"])
        seen = int(resume["seen"])

    def make_state(extra: dict) -> dict:
        state = {
            "kind": "restream",
            "config_json": config_json,
            "n": n,
            "pos": stream.tell(),
            "block": block,
            "loads": loads,
            "cut_weight": cm.snapshot(),
            "pass_idx": pass_idx,
            "cut_before": cut_before,
            "log": dict(log),
            "passes": list(info.passes),
            "peak_resident_bytes": info.peak_resident_bytes,
            "stream_bytes_read": bytes_base + (stream.bytes_read - bytes0),
            "seen": seen,
            "total_batches": total_batches[0],
            "adj": pack_adjacency(adj),
        }
        state.update(extra)
        return state

    def note_peak(extra: int = 0) -> None:
        resident = adj.resident_bytes + stream.resident_bytes + extra
        if resident > info.peak_resident_bytes:
            info.peak_resident_bytes = resident

    def bump_total() -> None:
        total_batches[0] += 1

    micro = MicroRestreamer(
        n, block, loads, cm, cfg, p, adj,
        log=log, on_peak=note_peak, on_commit=bump_total,
    )
    commit, commit_hub = micro.commit, micro.commit_hub

    where = f" during restream pass {pass_idx + 1}"
    records = (stream.iter_from(dict(resume["pos"])) if resume is not None
               else iter(stream))
    if order == "stream":
        # contiguous δ-batches in stream order (paper Table 2 replay)
        pend: list[int] = ([int(x) for x in np.asarray(resume["pend"]).tolist()]
                           if resume is not None else [])
        for v, nbrs, w, node_w in records:
            adj.put(v, nbrs, w, node_w)
            note_peak()
            seen += 1
            if nbrs.size > cfg.d_max:
                commit_hub(v, node_w)
            else:
                pend.append(v)
                if len(pend) == cfg.batch_size:
                    commit(np.asarray(pend, dtype=np.int64))
                    pend.clear()
            if ckpt is not None:
                ckpt.maybe_save(
                    total_batches[0],
                    lambda: make_state({"pend": np.asarray(pend, dtype=np.int64)}),
                )
        if pend:
            commit(np.asarray(pend, dtype=np.int64))
        _check_replay(stream, seen, where)
        return log

    # priority: bounded buffer of streamed gain estimates, δ best evict first
    buf: list[int] = ([int(x) for x in np.asarray(resume["buf"]).tolist()]
                      if resume is not None else [])
    gains: list[float] = ([float(x) for x in np.asarray(resume["gains"]).tolist()]
                          if resume is not None else [])

    def evict_batch() -> None:
        nonlocal buf, gains
        take = min(cfg.batch_size, len(buf))
        # highest gain first, node id breaks ties — deterministic on every
        # backend because the gains are computed from identical records
        idx = np.lexsort((np.asarray(buf, dtype=np.int64),
                          -np.asarray(gains, dtype=np.float64)))
        pick = idx[:take]
        commit(np.asarray(buf, dtype=np.int64)[pick])
        keep = np.ones(len(buf), dtype=bool)
        keep[pick] = False
        buf = [u for u, k_ in zip(buf, keep) if k_]
        gains = [g_ for g_, k_ in zip(gains, keep) if k_]

    for v, nbrs, w, node_w in records:
        adj.put(v, nbrs, w, node_w)
        note_peak()
        seen += 1
        if nbrs.size > cfg.d_max:
            commit_hub(v, node_w)
        else:
            buf.append(v)
            gains.append(_move_gain(v, nbrs, w, block, cfg.k))
            while len(buf) >= cfg.buffer_size:
                evict_batch()
        if ckpt is not None:
            ckpt.maybe_save(
                total_batches[0],
                lambda: make_state({
                    "buf": np.asarray(buf, dtype=np.int64),
                    "gains": np.asarray(gains, dtype=np.float64),
                }),
            )
    while buf:
        evict_batch()
    _check_replay(stream, seen, where)
    return log


def restream_pass(
    source: "CSRGraph | NodeStreamBase", block: np.ndarray, cfg: BuffCutConfig
) -> np.ndarray:
    """One restreaming pass in stream order (legacy signature; accepts any
    CSRGraph or replayable NodeStreamBase, disk-backed included)."""
    out, _ = restream_refine(source, block, cfg, 1)
    return out


def restream(
    source: "CSRGraph | NodeStreamBase",
    block: np.ndarray,
    cfg: BuffCutConfig,
    passes: int,
    order: str = "stream",
) -> np.ndarray:
    """Apply `passes` additional restreaming passes (paper Table 2 rows)."""
    out, _ = restream_refine(source, block, cfg, passes, order=order)
    return out
