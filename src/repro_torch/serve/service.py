"""PartitionService — a partition kept *alive* under graph mutation.

The offline pipeline ends at a label array; real deployments (CUTTANA's
graph-database motivation, arXiv:2312.08356) start there: the graph keeps
mutating under load and the partition must follow without ever recomputing
from scratch.  This module is the resident core of that story.

Resident state:

* the label array (int64, grows with node adds) and per-block float64
  loads — the same pair every streaming driver maintains;
* the exact edge cut via `metrics.IncrementalCut` — graph deltas fold in
  through `apply_edge_delta`, label moves through the stage/commit bracket,
  so ``service.cut_weight == edge_cut(service.export_graph(), labels)``
  holds at every quiescent point;
* adjacency as an immutable base `CSRGraph` plus per-row overlay dicts for
  mutated rows (both directions kept symmetric, self-loops never stored,
  duplicate insertions accumulate weight — `CSRGraph.from_edges` simple-
  graph semantics), materialized through a bounded LRU `AdjacencyCache`
  of hot rows;
* a standing bounded priority buffer of *touched* nodes with streamed gain
  estimates (weight to the best-connected block minus weight to the current
  block — the same priority as ``restream_order="priority"``).

Three verbs:

* ``lookup(nodes)`` — gather labels (no state change beyond counters);
* ``update(...)`` — apply node adds, edge insertions, edge deletions:
  cut/loads adjust exactly in place, touched endpoints (re-)enter the
  priority buffer with fresh gains, new nodes are placed immediately via
  Fennel (the hub bypass path with an empty adjacency);
* ``refine(budget)`` — drain the highest-gain buffered nodes in δ-batches
  through `restream.MicroRestreamer`, i.e. the *same* batch-multilevel
  machinery the offline restream passes use; hub rows (deg > d_max) bypass
  the batch via immediate Fennel, exactly Alg. 1.

Each refine batch's V-cycle runs on `cfg.ml.device` for the device engines
("cuda" by default: the `ell_histogram` kernel and one `fennel_sweep`
launch per V-cycle for engine "torch").  The service checks the device and
builds the kernels once, at construction (`repro_torch.device.preflight`).
There is no host fallback: a device error in a refine reaches the caller,
and the refine log has no `engine_fallbacks` count.

Everything is deterministic: one update/refine stream applied twice from
the same starting partition yields bit-identical labels (ties in the
priority drain break by node id, exactly the restream eviction order).

Weight caveat for *exact* cut pinning: `CSRGraph` stores float32 edge
weights and `edge_cut` sums them in float32, while the incremental
maintainer accumulates float64 deltas.  With integer-valued weights (the
default 1.0, and everything the workloads generate) both are exact and
compare equal; arbitrary float weights agree only to float32 rounding.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np

from repro_torch.core.buffcut import BuffCutConfig
from repro_torch.core.fennel import FennelParams, fennel_choose
from repro_torch.core.metrics import IncrementalCut, edge_cut
from repro_torch.core.rescore import AdjacencyCache
from repro_torch.core.restream import MicroRestreamer, _move_gain
from repro_torch.device import preflight
from repro_torch.graphs.csr import CSRGraph

_EMPTY_I = np.empty(0, dtype=np.int64)
_EMPTY_W = np.empty(0, dtype=np.float64)

#: default hot-row cache budget (bytes): big enough to keep a mesh-sized
#: working set resident, small enough that the service's footprint stays
#: dominated by the O(n) label array.
DEFAULT_CACHE_BYTES = 4 << 20


class HotAdjacencyCache:
    """Bounded LRU of materialized adjacency rows.

    Composes `rescore.AdjacencyCache` (the storage + byte accounting every
    streaming driver uses) with an `OrderedDict` recency list: `get` moves a
    row to the back, `put` evicts from the front while over budget.  Rows a
    delta touches are dropped (`invalidate`) and re-materialized lazily.
    """

    def __init__(self, budget_bytes: int):
        if budget_bytes < 0:
            raise ValueError(f"cache budget must be >= 0, got {budget_bytes}")
        self.budget_bytes = int(budget_bytes)
        self.adj = AdjacencyCache()
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, v: int) -> "tuple[np.ndarray, np.ndarray] | None":
        if v in self.adj:
            self.hits += 1
            self._lru.move_to_end(v)
            return self.adj._nbr[v], self.adj._w[v]
        self.misses += 1
        return None

    def put(self, v: int, nbrs: np.ndarray, w: np.ndarray, node_w: float) -> None:
        if v in self.adj:
            self.adj.drop_one(v)
            self._lru.pop(v)
        self.adj.put(v, nbrs, w, node_w)
        self._lru[v] = None
        while self.adj.resident_bytes > self.budget_bytes and len(self._lru) > 1:
            old, _ = self._lru.popitem(last=False)
            self.adj.drop_one(old)

    def invalidate(self, v: int) -> None:
        if v in self.adj:
            self.adj.drop_one(v)
            self._lru.pop(v)

    @property
    def resident_bytes(self) -> int:
        return self.adj.resident_bytes

    def __len__(self) -> int:
        return len(self._lru)


class PartitionService:
    """Resident partition with incremental repartitioning (module docstring
    has the full contract).  Thread-safe via one reentrant lock; the
    intended front door for concurrent clients is `serve.session.ServeSession`,
    which serializes requests through a bounded queue + worker thread.

    Construct from a partitioned graph and its labels (for example a
    driver's output, with its `stats.cut_weight` and `stats.block_loads`).
    """

    def __init__(
        self,
        graph: CSRGraph,
        labels: np.ndarray,
        cfg: BuffCutConfig,
        *,
        cut_weight: "float | None" = None,
        block_loads: "np.ndarray | None" = None,
        buffer_cap: "int | None" = None,
        refine_batch: "int | None" = None,
        cache_bytes: int = DEFAULT_CACHE_BYTES,
    ):
        labels = np.asarray(labels, dtype=np.int64)
        if labels.shape[0] != graph.n:
            raise ValueError(
                f"label array has {labels.shape[0]} entries, graph has "
                f"{graph.n} nodes"
            )
        if labels.size and ((labels < 0).any() or (labels >= cfg.k).any()):
            raise ValueError(
                "PartitionService needs a complete assignment: every label "
                f"in [0, {cfg.k})"
            )
        if cfg.ml.engine != "sparse":
            preflight(cfg.ml.device)
        self._cfg = cfg
        self._base = graph
        self._overlay: dict[int, dict[int, float]] = {}
        self._n = graph.n
        self._m = graph.m
        self._labels = labels.copy()
        self._node_w = graph.node_w.astype(np.float32).copy()
        if block_loads is None:
            loads = np.zeros(cfg.k, dtype=np.float64)
            np.add.at(loads, self._labels, self._node_w.astype(np.float64))
        else:
            loads = np.asarray(block_loads, dtype=np.float64).copy()
            if loads.shape[0] != cfg.k:
                raise ValueError(
                    f"block_loads has {loads.shape[0]} blocks, config has "
                    f"k={cfg.k}"
                )
        self._loads = loads
        self._n_total = float(loads.astype(np.float64).sum())
        self._m_total = float(graph.edge_w.astype(np.float64).sum() / 2.0)
        if cut_weight is None:
            cut_weight = edge_cut(graph, self._labels)
        self._cm = IncrementalCut(float(cut_weight))
        self.buffer_cap = int(buffer_cap if buffer_cap is not None
                              else cfg.buffer_size)
        if self.buffer_cap < 1:
            raise ValueError(f"buffer_cap must be >= 1, got {self.buffer_cap}")
        self.refine_batch = int(refine_batch if refine_batch is not None
                                else cfg.batch_size)
        if self.refine_batch < 1:
            raise ValueError(f"refine_batch must be >= 1, got {self.refine_batch}")
        # standing priority buffer: node -> streamed gain estimate
        self._buffer: dict[int, float] = {}
        self._hot = HotAdjacencyCache(cache_bytes)
        self._lock = threading.RLock()
        # a refine that raised mid-batch leaves the batch detached: every
        # later verb refuses to serve that state
        self._failed: "BaseException | None" = None
        self.counters = {
            "lookups": 0, "lookup_nodes": 0,
            "updates": 0, "edge_inserts": 0, "edge_deletes": 0,
            "duplicate_merges": 0, "self_loops_ignored": 0, "nodes_added": 0,
            "refines": 0, "redecided": 0, "buffer_overflow_dropped": 0,
        }

    # ----------------------------------------------------------- properties
    @property
    def n(self) -> int:
        return self._n

    @property
    def m(self) -> int:
        """Current undirected edge count."""
        return self._m

    @property
    def k(self) -> int:
        return self._cfg.k

    @property
    def cfg(self) -> BuffCutConfig:
        return self._cfg

    @property
    def cut_weight(self) -> float:
        """Exact edge cut of the current labels on the current graph."""
        return self._cm.cut_weight

    @property
    def balance(self) -> float:
        return (float(self._loads.max() / (self._n_total / self._cfg.k))
                if self._n_total > 0 else 1.0)

    @property
    def block_loads(self) -> np.ndarray:
        return self._loads.copy()

    @property
    def labels(self) -> np.ndarray:
        return self._labels.copy()

    @property
    def buffered(self) -> int:
        """Nodes currently awaiting re-decision in the priority buffer."""
        return len(self._buffer)

    @property
    def params(self) -> FennelParams:
        """Fennel params tracking the *mutated* totals, so refine decisions
        price balance against the graph as it is now, not as it streamed."""
        return FennelParams(
            k=self._cfg.k, n_total=self._n_total, m_total=self._m_total,
            eps=self._cfg.eps, gamma=self._cfg.gamma,
        )

    # ------------------------------------------------------------ adjacency
    def _row(self, v: int) -> tuple[np.ndarray, np.ndarray]:
        """Current adjacency of `v` (int64 ids, float64 weights) —
        overlay row if mutated, base CSR row otherwise."""
        row = self._overlay.get(v)
        if row is not None:
            if not row:
                return _EMPTY_I, _EMPTY_W
            return (np.fromiter(row.keys(), dtype=np.int64, count=len(row)),
                    np.fromiter(row.values(), dtype=np.float64, count=len(row)))
        g = self._base
        return (g.neighbors(v).astype(np.int64),
                g.neighbor_weights(v).astype(np.float64))

    def _adjacency(self, v: int) -> tuple[np.ndarray, np.ndarray]:
        """`_row` through the bounded hot cache."""
        hit = self._hot.get(v)
        if hit is not None:
            return hit
        nbrs, w = self._row(v)
        self._hot.put(v, nbrs, w, float(self._node_w[v]))
        return nbrs, w

    def _ensure_overlay(self, v: int) -> dict[int, float]:
        row = self._overlay.get(v)
        if row is None:
            if v < self._base.n:
                row = dict(zip(self._base.neighbors(v).astype(np.int64).tolist(),
                               self._base.neighbor_weights(v)
                               .astype(np.float64).tolist()))
            else:
                row = {}
            self._overlay[v] = row
        return row

    def _check_node(self, v: int, what: str) -> None:
        if not 0 <= v < self._n:
            raise ValueError(
                f"{what} references node {v}, but the service holds nodes "
                f"[0, {self._n}) — add nodes first (update(add_nodes=...))"
            )

    # ---------------------------------------------------------------- verbs
    def lookup(self, nodes) -> np.ndarray:
        """Gather current labels for `nodes` (any int array-like)."""
        nodes = np.asarray(nodes, dtype=np.int64)
        with self._lock:
            if nodes.size and (int(nodes.min()) < 0 or int(nodes.max()) >= self._n):
                bad = int(nodes[(nodes < 0) | (nodes >= self._n)][0])
                raise ValueError(
                    f"lookup references node {bad}, but the service holds "
                    f"nodes [0, {self._n})"
                )
            self._check_usable()
            self.counters["lookups"] += 1
            self.counters["lookup_nodes"] += int(nodes.size)
            return self._labels[nodes].copy()

    def _touch(self, v: int) -> None:
        """(Re-)enter `v` into the standing priority buffer with a fresh
        streamed gain estimate; over capacity, the lowest-gain entries are
        dropped (they had the least to win from a re-decision)."""
        nbrs, w = self._adjacency(v)
        self._buffer[v] = _move_gain(v, nbrs, w, self._labels, self._cfg.k)
        over = len(self._buffer) - self.buffer_cap
        if over > 0:
            ids = np.fromiter(self._buffer.keys(), dtype=np.int64,
                              count=len(self._buffer))
            gains = np.fromiter(self._buffer.values(), dtype=np.float64,
                                count=len(self._buffer))
            # lowest gain first, node id breaks ties — deterministic
            drop = ids[np.lexsort((ids, gains))[:over]]
            for u in drop.tolist():
                del self._buffer[u]
            self.counters["buffer_overflow_dropped"] += over

    def update(
        self,
        *,
        add_nodes=None,
        insert_edges=None,
        delete_edges=None,
    ) -> dict:
        """Apply one batch of graph deltas; cut and loads adjust exactly in
        place and every touched endpoint enters the priority buffer.

        Order within the batch: node adds first (so inserted edges may
        reference them), then insertions in row order, then deletions in row
        order.

        * ``add_nodes`` — int count (unit weights) or iterable of node
          weights; each new node is assigned immediately via Fennel.
        * ``insert_edges`` — rows ``(u, v[, w])`` (w defaults to 1.0, must
          be > 0).  Inserting an existing edge *accumulates* its weight;
          self-loops are accepted, counted, and dropped (never stored, never
          cut) — `CSRGraph.from_edges` semantics.
        * ``delete_edges`` — rows ``(u, v)``; deleting an absent edge is a
          loud `ValueError` (nothing silently vanishes), deletion removes
          the edge's full accumulated weight.

        Returns a summary dict (counts + the new node ids).
        """
        with self._lock:
            self._check_usable()
            summary = {"nodes_added": [], "edge_inserts": 0, "edge_deletes": 0,
                       "duplicate_merges": 0, "self_loops_ignored": 0,
                       "cut_delta": 0.0}
            if add_nodes is not None:
                if isinstance(add_nodes, (int, np.integer)):
                    weights = [1.0] * int(add_nodes)
                else:
                    weights = [float(x) for x in add_nodes]
                for w in weights:
                    if w <= 0:
                        raise ValueError(
                            f"node weights must be > 0, got {w}")
                if weights:
                    kn = len(weights)
                    self._labels = np.concatenate(
                        [self._labels, np.full(kn, -1, dtype=np.int64)])
                    self._node_w = np.concatenate(
                        [self._node_w, np.asarray(weights, dtype=np.float32)])
                    for i, _w in enumerate(weights):
                        v = self._n + i
                        self._overlay[v] = {}
                        blk = fennel_choose(
                            _EMPTY_I, _EMPTY_W, float(self._node_w[v]),
                            self._labels, self._loads, self.params)
                        self._labels[v] = blk
                        self._loads[blk] += float(self._node_w[v])
                        self._n_total += float(self._node_w[v])
                        summary["nodes_added"].append(v)
                    self._n += kn
                    self.counters["nodes_added"] += kn
            for row in ([] if insert_edges is None else insert_edges):
                row = np.asarray(row).ravel()
                u, v = int(row[0]), int(row[1])
                w = float(row[2]) if row.shape[0] > 2 else 1.0
                if w <= 0:
                    raise ValueError(
                        f"edge weights must be > 0, got {w} for ({u}, {v})")
                self._check_node(u, "edge insertion")
                self._check_node(v, "edge insertion")
                summary["cut_delta"] += self._cm.apply_edge_delta(
                    u, v, w, self._labels)
                if u == v:
                    summary["self_loops_ignored"] += 1
                    self.counters["self_loops_ignored"] += 1
                    continue
                ru = self._ensure_overlay(u)
                rv = self._ensure_overlay(v)
                if v in ru:
                    ru[v] += w
                    rv[u] += w
                    summary["duplicate_merges"] += 1
                    self.counters["duplicate_merges"] += 1
                else:
                    ru[v] = w
                    rv[u] = w
                    self._m += 1
                self._m_total += w
                summary["edge_inserts"] += 1
                self.counters["edge_inserts"] += 1
                self._hot.invalidate(u)
                self._hot.invalidate(v)
                self._touch(u)
                self._touch(v)
            for row in ([] if delete_edges is None else delete_edges):
                row = np.asarray(row).ravel()
                u, v = int(row[0]), int(row[1])
                if u == v:
                    raise ValueError(
                        f"cannot delete self-loop ({u}, {u}): self-loops are "
                        "never stored (simple-graph semantics)")
                self._check_node(u, "edge deletion")
                self._check_node(v, "edge deletion")
                ru = self._ensure_overlay(u)
                if v not in ru:
                    raise ValueError(
                        f"cannot delete edge ({u}, {v}): no such edge in the "
                        "current graph")
                w_cur = ru[v]
                summary["cut_delta"] += self._cm.apply_edge_delta(
                    u, v, -w_cur, self._labels)
                del ru[v]
                del self._ensure_overlay(v)[u]
                self._m -= 1
                self._m_total -= w_cur
                summary["edge_deletes"] += 1
                self.counters["edge_deletes"] += 1
                self._hot.invalidate(u)
                self._hot.invalidate(v)
                self._touch(u)
                self._touch(v)
            self.counters["updates"] += 1
            summary["buffered"] = len(self._buffer)
            summary["cut_weight"] = self._cm.cut_weight
            return summary

    def _check_usable(self) -> None:
        if self._failed is not None:
            raise RuntimeError(
                "PartitionService is unusable: a refine failed mid-batch"
            ) from self._failed

    def _drain(self, micro: MicroRestreamer, adj: AdjacencyCache, budget: int) -> int:
        """Re-decide up to `budget` buffered nodes; returns how many."""
        redecided = 0
        while self._buffer and redecided < budget:
            take = min(self.refine_batch, budget - redecided,
                       len(self._buffer))
            ids = np.fromiter(self._buffer.keys(), dtype=np.int64,
                              count=len(self._buffer))
            gains = np.fromiter(self._buffer.values(), dtype=np.float64,
                                count=len(self._buffer))
            # highest gain first, node id breaks ties — the restream
            # priority eviction order
            pick = ids[np.lexsort((ids, -gains))[:take]]
            batch: list[int] = []
            for v in pick.tolist():
                del self._buffer[v]
                nbrs, w = self._adjacency(v)
                adj.put(v, nbrs, w, float(self._node_w[v]))
                if nbrs.size > self._cfg.d_max:
                    micro.commit_hub(v, float(self._node_w[v]))
                else:
                    batch.append(v)
            if batch:
                micro.commit(np.asarray(batch, dtype=np.int64))
            redecided += int(pick.size)
        return redecided

    def refine(self, budget: "int | None" = None) -> dict:
        """Drain up to `budget` buffered nodes (default: all), highest gain
        first, in δ-batches of `refine_batch` through the batch-multilevel
        engine (`MicroRestreamer.commit`); rows over d_max bypass via
        immediate Fennel (`commit_hub`).  Gains are as-of touch time —
        the drain order is a priority schedule, not a live heap — but every
        drained node is re-decided against the *live* labels and loads.

        Returns a summary dict under the restream pass-log schema plus
        cut before/after.  An error of a batch (a device error of its
        V-cycle) propagates, and leaves the service refusing every later
        verb: the failed batch's nodes stay detached.
        """
        with self._lock:
            self._check_usable()
            if budget is None:
                budget = len(self._buffer)
            budget = int(budget)
            if budget < 0:
                raise ValueError(f"refine budget must be >= 0, got {budget}")
            log = {"n_batches": 0, "n_hubs": 0, "moved": 0}
            cut_before = self._cm.cut_weight
            adj = AdjacencyCache()
            micro = MicroRestreamer(
                self._n, self._labels, self._loads, self._cm, self._cfg,
                self.params, adj, log=log,
            )
            try:
                redecided = self._drain(micro, adj, budget)
            except BaseException as e:
                self._failed = e
                raise
            self.counters["refines"] += 1
            self.counters["redecided"] += redecided
            out = dict(log)
            out.update({
                "budget": budget, "redecided": redecided,
                "cut_before": cut_before, "cut_after": self._cm.cut_weight,
                "buffered": len(self._buffer),
            })
            return out

    # ------------------------------------------------------------- export
    def export_graph(self) -> CSRGraph:
        """Materialize the *current* graph (base + overlay) as a fresh
        `CSRGraph` — the reference object for exactness pinning
        (``edge_cut(service.export_graph(), service.labels)``) and for
        from-scratch repartition comparisons."""
        with self._lock:
            srcs, dsts, ws = [], [], []
            for v in range(self._n):
                nbrs, w = self._row(v)
                m = nbrs > v
                cnt = int(np.count_nonzero(m))
                if cnt:
                    srcs.append(np.full(cnt, v, dtype=np.int64))
                    dsts.append(nbrs[m])
                    ws.append(w[m])
            if srcs:
                edges = np.stack(
                    [np.concatenate(srcs), np.concatenate(dsts)], axis=1)
                weights = np.concatenate(ws).astype(np.float32)
            else:
                edges = np.empty((0, 2), dtype=np.int64)
                weights = np.empty(0, dtype=np.float32)
            return CSRGraph.from_edges(
                self._n, edges, weights, node_weights=self._node_w.copy())

    def stats(self) -> dict:
        """Resident-state snapshot: sizes, quality, cache/buffer occupancy,
        and the cumulative verb counters."""
        with self._lock:
            return {
                "n": self._n, "m": self._m, "k": self._cfg.k,
                "cut_weight": self._cm.cut_weight,
                "balance": self.balance,
                "n_total": self._n_total, "m_total": self._m_total,
                "buffered": len(self._buffer),
                "buffer_cap": self.buffer_cap,
                "overlay_rows": len(self._overlay),
                "cache_resident_bytes": self._hot.resident_bytes,
                "cache_rows": len(self._hot),
                "cache_hits": self._hot.hits,
                "cache_misses": self._hot.misses,
                "counters": dict(self.counters),
            }
