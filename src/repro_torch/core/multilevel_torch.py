"""Device-resident multilevel batch engine — `MultilevelConfig(engine="torch")`.

The port of `repro/core/multilevel_jax.py`.  The whole per-batch V-cycle
(DESIGN.md §3.5) stays on `cfg.device`:

  pack      the batch model graph is packed once into pow2-bucketed padded
            buffers by `kernels/csr_pack.py` from the compact CSR: on a
            card the host uploads it in one pinned block and the CUDA
            kernel writes the padding, on the CPU its plain version does
            (the host's `CSRGraph.to_coo_padded` / `to_ell_padded` are the
            tests' oracle of both),
  coarsen   LP clustering rounds; contraction is a segmented sum over
            composite (coarse-src, coarse-dst) keys into the same buffers,
  initial   weighted Fennel on the coarsest level, sequential over the
            (≤ coarsen_target) free nodes: one launch of the CUDA sweep
            kernel on a card (`kernels/fennel_gain.py::fennel_sweep`),
  refine    capacity-constrained LP refinement rounds per level.

Neighbor-label aggregation has three modes, picked per level by padded
volume (`_pick_mode`):

  dense   a dense (n_pad, L_pad) count matrix,
  ell     the padded ELL tiles through `block_histogram` — the CUDA
          `ell_histogram` kernel on a card (level 0 only: coarse degrees
          outgrow the tiles),
  sort    segmented sort + prefix sums over composite keys, any shape.

Arithmetic is int64/float64 throughout (the reference ran under x64), and
every reduction that feeds a label is fixed-order: sums are stable-sort +
cumsum differences (`_segment_sum`), maxima and minima are
`scatter_reduce` (exact in any order), and float sort keys are normalized
so -0.0 and +0.0 tie.  No float atomics, so labels are bit-deterministic
and, on integer-weight graphs, identical to the host `sparse` engine.
Labels leave the device once per batch; the host level loop pulls a few
scalars per level.
"""
from __future__ import annotations

import math
import threading
import time

import numpy as np
import torch  # repro: noqa RPR001 -- whole-module torch engine; lazy from multilevel.py

from repro_torch import tracing
from repro_torch.core.fennel import FennelParams
from repro_torch.core.multilevel import _ELL_VOLUME_CAP as ELL_VOLUME_CAP
from repro_torch.core.multilevel import _ELL_WIDTH_CAP as ELL_WIDTH_CAP
from repro_torch.device import resolve_device
from repro_torch.graphs.csr import CSRGraph, bucket_size
from repro_torch.kernels.csr_pack import (compact_layout, compact_views, csr_pack,
                                          pack_outputs)
from repro_torch.kernels.ell_histogram import block_histogram
from repro_torch.kernels.fennel_gain import fennel_sweep

# dense (n_pad · L_pad) count-matrix entry ceiling; above it the sort mode
# takes over (the TPU value of the reference; not yet tuned on the H100)
DENSE_VOLUME_CAP = 1 << 22

# tests force a mode ("dense" | "ell" | "sort") to pin cross-mode parity
MODE_OVERRIDE: str | None = None

# dense-mode exploration ceiling for the autotuner
_AUTOTUNE_DENSE_CAP = 1 << 24

_NEG_INF = -math.inf


class _AggTuner:
    """Measured-time aggregation-mode selection (`MultilevelConfig.agg_autotune`).

    Keyed by ``(phase, n_pad, l_pad)``; for each key it round-robins the
    candidate modes — one untimed warmup call per mode, then ``TIMED``
    timed calls per mode, each synchronized with the device — then commits
    to the fastest mean.  All modes give identical labels, so exploration
    changes wall clock, never output.  One tuner serves every thread of the
    process (the sharded driver's workers), under a lock.
    """

    WARMUP = 1
    TIMED = 2

    def __init__(self) -> None:
        self._samples: dict[tuple, dict[str, list[float]]] = {}
        self._decided: dict[tuple, str] = {}
        self._lock = threading.Lock()

    def choose(self, key: tuple, candidates: tuple[str, ...]) -> tuple[str, bool]:
        """Return ``(mode, explore)``; ``explore`` asks the caller to time
        this call and feed the duration back through `record`."""
        with self._lock:
            if key in self._decided:
                return self._decided[key], False
            per = self._samples.setdefault(key, {m: [] for m in candidates})
            mode = min(candidates, key=lambda m: len(per[m]))
            if len(per[mode]) >= self.WARMUP + self.TIMED:
                best = min(
                    candidates,
                    key=lambda m: sum(per[m][self.WARMUP:]) / self.TIMED,
                )
                self._decided[key] = best
                return best, False
            return mode, True

    def record(self, key: tuple, mode: str, dt: float) -> None:
        with self._lock:
            self._samples[key][mode].append(dt)


_TUNER = _AggTuner()


def agg_decisions() -> dict[tuple, str]:
    """Committed (phase, n_pad, l_pad) -> mode picks so far."""
    with _TUNER._lock:
        return dict(_TUNER._decided)


def reset_agg_tuner() -> None:
    global _TUNER
    _TUNER = _AggTuner()


# --------------------------------------------------------------------------
# fixed-order segmented reductions
# --------------------------------------------------------------------------

def _starts(x: torch.Tensor) -> torch.Tensor:
    """True where a run of equal values begins (x sorted or grouped)."""
    s = torch.ones_like(x, dtype=torch.bool)
    s[1:] = x[1:] != x[:-1]
    return s


def _ends(x: torch.Tensor) -> torch.Tensor:
    """True where a run of equal values ends."""
    e = torch.ones_like(x, dtype=torch.bool)
    e[:-1] = x[1:] != x[:-1]
    return e


def _run_totals(w_s: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """Running total of `w_s` restarted wherever `start` is True: the
    cumsum minus the cummax of the cumsum before each run — read at a
    run's end it is the run's sum."""
    csum = torch.cumsum(w_s, 0)
    base = torch.where(start, csum - w_s, _NEG_INF)
    return csum - torch.cummax(base, 0).values


def _segment_sum(vals: torch.Tensor, seg: torch.Tensor, num: int) -> torch.Tensor:
    """out[s] = Σ vals[seg == s] for s in [0, num), in a fixed order
    (stable sort by segment, restarted cumsum, one write per segment)."""
    seg_s, order = torch.sort(seg, stable=True)
    total = _run_totals(vals[order], _starts(seg_s))
    slot = torch.where(_ends(seg_s), seg_s, num)  # non-ends to a spare slot
    out = torch.zeros(num + 1, dtype=vals.dtype, device=vals.device)
    return out.scatter_(0, slot, total)[:num]


def _segment_reduce(seg: torch.Tensor, val: torch.Tensor, num: int, op: str,
                    fill) -> torch.Tensor:
    """Per-segment max or min ("amax" | "amin") for segments [0, num);
    segment ids >= num (padding sentinels) are dropped, empty segments get
    `fill`.  Exact in any order, so atomics cannot change the result."""
    out = torch.full((num + 1,), fill, dtype=val.dtype, device=val.device)
    out.scatter_reduce_(0, seg.clamp(max=num), val, reduce=op, include_self=True)
    return out[:num]


def _sort_key_f64(x: torch.Tensor) -> torch.Tensor:
    """Float sort key with -0.0 folded into +0.0 (a radix sort orders them)."""
    return x + 0.0


# --------------------------------------------------------------------------
# aggregation: per-node (cur_conn, best_w, best_lab) from neighbor labels
# --------------------------------------------------------------------------

def _edge_labels(edst: torch.Tensor, labels: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Label of each directed edge's head; sentinel edges -> -1."""
    return torch.where(edst >= n_pad, -1, labels[edst.clamp(max=n_pad - 1)])


def _best_from_counts(
    counts: torch.Tensor,
    own: torch.Tensor,
    forbidden_cols: torch.Tensor | None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row-wise epilogue over a dense (rows, L) count matrix: own-label
    connectivity, forbidden and own columns masked to -inf, first-max
    argmax (columns are ascending labels, so ties go to the lower one)."""
    l_pad = counts.shape[1]
    own_c = own.clamp(0, l_pad - 1)
    cur_conn = torch.where(own >= 0, counts.gather(1, own_c[:, None])[:, 0], 0.0)
    if forbidden_cols is not None:
        counts = counts.masked_fill(forbidden_cols[None, :], _NEG_INF)
    col_ids = torch.arange(l_pad, device=counts.device)
    counts = counts.masked_fill(col_ids[None, :] == own[:, None], _NEG_INF)
    best_col = counts.argmax(1)
    best_w = counts.gather(1, best_col[:, None])[:, 0]
    return cur_conn, best_w, best_col


def _agg_dense(esrc, edst, ew, labels, own, forbidden_cols, n_pad: int, l_pad: int):
    """Dense (n_pad, l_pad) counts, summed per cell in a fixed order."""
    lab = _edge_labels(edst, labels, n_pad)
    valid = (esrc < n_pad) & (lab >= 0)
    flat = torch.where(valid, esrc * l_pad + lab.clamp(0, l_pad - 1), n_pad * l_pad)
    counts = _segment_sum(torch.where(valid, ew, 0.0), flat, n_pad * l_pad)
    return _best_from_counts(counts.view(n_pad, l_pad), own, forbidden_cols)


def _agg_ell(nbr, wts, labels, own, forbidden_cols, n_pad: int, l_pad: int):
    """ELL tiles through the histogram kernel (plain version on the CPU)."""
    mask = nbr >= 0
    lab = torch.where(mask, labels[nbr.clamp(0, n_pad - 1)], -1)
    counts = block_histogram(lab.to(torch.int32), wts, l_pad)
    # f32 kernel accumulator -> f64 epilogue, as the reference casts
    return _best_from_counts(counts.double(), own, forbidden_cols)


def _agg_sort(esrc, edst, ew, labels, own, forbidden, n_pad: int):
    """Segmented-sort aggregation: no dense scratch, any label domain."""
    lab = _edge_labels(edst, labels, n_pad)
    valid = (esrc < n_pad) & (lab >= 0)
    base = n_pad + 1
    key = torch.where(valid, esrc * base + lab, base * base - 1)
    key_s, order = torch.sort(key, stable=True)
    w_s = ew[order]
    src_s = (key_s // base).clamp(max=n_pad)
    lab_s = key_s % base
    total = _run_totals(w_s, _starts(key_s))
    # zero-sum groups dropped, as the host bincount engine drops them
    live = _ends(key_s) & (src_s < n_pad) & (total != 0)
    own_s = own[src_s.clamp(max=n_pad - 1)]
    is_own = live & (lab_s == own_s)
    elig = live & ~is_own
    if forbidden is not None:
        elig &= ~forbidden[lab_s.clamp(0, n_pad - 1)]
    # <= 1 own group per node: the max picks it
    cur_conn = _segment_reduce(src_s, torch.where(is_own, total, _NEG_INF), n_pad,
                               "amax", _NEG_INF)
    cur_conn = torch.where(torch.isfinite(cur_conn), cur_conn, 0.0)
    best_w = _segment_reduce(src_s, torch.where(elig, total, _NEG_INF), n_pad,
                             "amax", _NEG_INF)
    is_best = elig & (total == best_w[src_s.clamp(max=n_pad - 1)])
    best_lab = _segment_reduce(src_s, torch.where(is_best, lab_s, base), n_pad,
                               "amin", base)
    return cur_conn, best_w, best_lab


def _agg_round0(esrc, edst, ew, forbidden, n_pad: int):
    """Clustering round 0: labels are all-distinct (cluster = arange), so
    the edge list *is* the histogram — per-node max edge weight, ties to the
    lower neighbor id, zero-weight edges dropped."""
    valid = (esrc < n_pad) & (ew != 0)
    elig = valid & ~forbidden[edst.clamp(max=n_pad - 1)]
    best_w = _segment_reduce(esrc, torch.where(elig, ew, _NEG_INF), n_pad,
                             "amax", _NEG_INF)
    is_best = elig & (ew == best_w[esrc.clamp(max=n_pad - 1)])
    best_lab = _segment_reduce(esrc, torch.where(is_best, edst, n_pad), n_pad,
                               "amin", n_pad)
    # no self loops -> own-label connectivity is identically zero
    return torch.zeros(n_pad, dtype=ew.dtype, device=ew.device), best_w, best_lab


def _aggregate(mode: str, esrc, edst, ew, nbr, wts, labels, own, forbidden,
               n_pad: int, l_pad: int):
    """Dispatch one of the three modes; `forbidden` is a label-domain mask."""
    if mode == "dense":
        return _agg_dense(esrc, edst, ew, labels, own, forbidden, n_pad, l_pad)
    if mode == "ell":
        return _agg_ell(nbr, wts, labels, own, forbidden, n_pad, l_pad)
    if mode == "sort":
        return _agg_sort(esrc, edst, ew, labels, own, forbidden, n_pad)
    raise ValueError(f"unknown aggregation mode {mode!r}")


# --------------------------------------------------------------------------
# greedy capacity acceptance
# --------------------------------------------------------------------------

def _accept_with_capacity(movers, targets, gains, node_w, capacity, n_pad: int):
    """Per-target gain-descending prefix acceptance.

    Non-movers sort behind every real target (sentinel target n_pad) with
    zero weight, so the per-group cumulative sums equal the host engine's
    compacted ones.  `lexsort((-gain, target))` is two stable sorts.
    """
    tgt = torch.where(movers, targets, n_pad)
    gn = torch.where(movers, gains, 0.0)
    by_gain = torch.sort(_sort_key_f64(-gn), stable=True).indices
    order = by_gain[torch.sort(tgt[by_gain], stable=True).indices]
    t_s = tgt[order]
    m_s = movers[order]
    w_s = torch.where(m_s, node_w[order], 0.0)
    within = _run_totals(w_s, _starts(t_s))  # cumsum restarted per target
    cap_t = torch.where(t_s >= n_pad, 0.0, capacity[t_s.clamp(0, n_pad - 1)])
    ok = m_s & (within <= cap_t + 1e-9)
    accept = torch.zeros(n_pad, dtype=torch.bool, device=movers.device)
    accept[order] = ok
    return accept


# --------------------------------------------------------------------------
# V-cycle stages
# --------------------------------------------------------------------------

def _lp_cluster(esrc, edst, ew, nbr, wts, node_w, pinned, n: int,
                max_cluster_w: float, *, iters: int, mode: str):
    """Size-constrained LP clustering; returns the cluster label vector."""
    n_pad = node_w.shape[0]
    ids = torch.arange(n_pad, device=node_w.device)
    valid = ids < n
    free = (pinned == -1) & valid
    # cluster labels are node ids, so the node-domain mask doubles as the
    # label-column mask (l_pad = n_pad)
    forbidden = pinned >= 0
    cluster = ids.clone()
    cw = torch.where(valid, node_w, 0.0)
    for round_idx in range(iters):
        if round_idx == 0:
            _, best_w, best_lab = _agg_round0(esrc, edst, ew, forbidden, n_pad)
        else:
            _, best_w, best_lab = _aggregate(
                mode, esrc, edst, ew, nbr, wts, cluster, cluster, forbidden,
                n_pad, n_pad)
        movers = free & (best_w > 0.0)
        movers &= cw[best_lab.clamp(0, n_pad - 1)] + node_w <= max_cluster_w
        capacity = (max_cluster_w - cw).clamp(min=0.0)
        accept = _accept_with_capacity(movers, best_lab, best_w, node_w,
                                       capacity, n_pad)
        wmv = torch.where(accept, node_w, 0.0)
        out = torch.where(accept, best_lab, n_pad)
        src_c = torch.where(accept, cluster, n_pad)
        cw = (cw - _segment_sum(wmv, src_c, n_pad + 1)[:n_pad]
              + _segment_sum(wmv, out, n_pad + 1)[:n_pad])
        cluster = torch.where(accept, best_lab, cluster)
    return cluster


def _contract(esrc, edst, ew, cluster, node_w, pinned, n: int):
    """Cluster contraction into the same padded buffers.

    Coarse ids are the ascending ranks of the surviving cluster ids (the
    twin of np.unique(..., return_inverse=True)); coarse edges are one
    segmented sum over composite keys, compacted to the front in key
    order.  Returns the coarse graph arrays, the fine->coarse node map and
    the coarse node and edge counts (0-d tensors).
    """
    n_pad = node_w.shape[0]
    e_pad = esrc.shape[0]
    dev = node_w.device
    ids = torch.arange(n_pad, device=dev)
    valid = ids < n
    cl = torch.where(valid, cluster, n_pad)
    sorted_cl = torch.sort(cl).values
    is_first = _starts(sorted_cl) & (sorted_cl < n_pad)
    rank = torch.cumsum(is_first, 0) - 1
    nc = is_first.sum()
    # duplicates of one cluster id carry one rank, so the writes agree
    value_rank = torch.zeros(n_pad + 1, dtype=cl.dtype, device=dev)
    value_rank[sorted_cl] = rank
    node_map = torch.where(valid, value_rank[cl.clamp(max=n_pad)], n_pad)

    cw = _segment_sum(torch.where(valid, node_w, 0.0),
                      torch.where(valid, node_map, n_pad), n_pad + 1)[:n_pad]
    pin_idx = torch.where(valid & (pinned >= 0), node_map, n_pad)
    cpin = _segment_reduce(pin_idx, torch.where(valid, pinned, -1), n_pad,
                           "amax", -1)
    cpin = torch.where(ids < nc, cpin, -2)

    epad = esrc >= n_pad
    s2 = torch.where(epad, n_pad, node_map[esrc.clamp(max=n_pad - 1)])
    d2 = torch.where(epad, n_pad, node_map[edst.clamp(max=n_pad - 1)])
    base = n_pad + 1
    drop = epad | (s2 == d2)
    key = torch.where(drop, base * base - 1, s2 * base + d2)
    key_s, order = torch.sort(key, stable=True)
    total = _run_totals(ew[order], _starts(key_s))
    gid = torch.cumsum(_starts(key_s), 0) - 1
    slot = torch.where(_ends(key_s), gid, e_pad)  # group g's end -> slot g
    sums = torch.zeros(e_pad + 1, dtype=ew.dtype, device=dev).scatter_(0, slot, total)[:e_pad]
    gkey = torch.full((e_pad + 1,), base * base - 1, dtype=key.dtype,
                      device=dev).scatter_(0, slot, key_s)[:e_pad]
    gsrc = gkey // base
    # zero-sum groups stay as zero-weight edges (every consumer ignores
    # them) so the coarse arrays stay src-sorted for _initial_fennel
    valid_g = (torch.arange(e_pad, device=dev) <= gid[-1]) & (gsrc < n_pad)
    esrc2 = torch.where(valid_g, gsrc, n_pad)
    edst2 = torch.where(valid_g, gkey % base, n_pad)
    ew2 = torch.where(valid_g, sums, 0.0)
    return esrc2, edst2, ew2, cw, cpin, node_map, nc, valid_g.sum()


def _initial_fennel(esrc, edst, ew, node_w, pinned, n: int, n_free: int,
                    loads0, alpha: float, gamma: float, cap: float, *, w_c: int):
    """Weighted Fennel on the coarsest level, heaviest free nodes first.

    Sequential by construction (each step sees the earlier placements).
    The edge arrays are src-sorted, so `indptr` gives each node's own edge
    segment; `fennel_sweep` walks the free nodes in `order`, on a card in
    one launch of the sweep kernel, on the CPU as eager steps that gather
    each segment at the fixed width `w_c` (host-bucketed max free degree).
    """
    n_pad = node_w.shape[0]
    dev = node_w.device
    ids = torch.arange(n_pad + 1, device=dev)
    valid = ids[:n_pad] < n
    free = (pinned == -1) & valid
    wkey = torch.where(free, node_w, _NEG_INF)
    order = torch.sort(_sort_key_f64(-wkey), stable=True).indices  # weight desc, id asc
    labels = torch.where(valid & (pinned >= 0), pinned, -1)
    indptr = torch.searchsorted(esrc, ids)
    return fennel_sweep(esrc, edst, ew, node_w, order, indptr, labels, loads0, n_free,
                        alpha=alpha, gamma=gamma, cap=cap, w_c=w_c)


def _lp_refine(esrc, edst, ew, nbr, wts, node_w, pinned, n: int, labels, loads,
               cap: float, *, rounds: int, mode: str):
    """Balanced synchronous LP refinement rounds at one level."""
    n_pad = node_w.shape[0]
    k = loads.shape[0]
    free = (pinned == -1) & (torch.arange(n_pad, device=node_w.device) < n)
    for _ in range(rounds):
        cur, best_w, best_lab = _aggregate(
            mode, esrc, edst, ew, nbr, wts, labels, labels, None, n_pad, k)
        gains = best_w - cur
        movers = free & (gains > 1e-12)
        capacity = torch.zeros(n_pad, dtype=loads.dtype, device=loads.device)
        capacity[:k] = (cap - loads).clamp(min=0.0)
        accept = _accept_with_capacity(movers, best_lab, gains, node_w,
                                       capacity, n_pad)
        wmv = torch.where(accept, node_w, 0.0)
        old = torch.where(accept, labels, k)
        new = torch.where(accept, best_lab, k)
        loads = (loads - _segment_sum(wmv, old, k + 1)[:k]
                 + _segment_sum(wmv, new, k + 1)[:k])
        labels = torch.where(accept, best_lab, labels)
    return labels, loads


def _project(labels, node_map, pinned):
    """Uncoarsen one level: inherit the coarse label, pinned override."""
    n_pad = labels.shape[0]
    fine = labels[node_map.clamp(0, n_pad - 1)]
    return torch.where(pinned >= 0, pinned, torch.where(node_map < n_pad, fine, -1))


# --------------------------------------------------------------------------
# host driver: level loop + packing
# --------------------------------------------------------------------------

def _pick_mode(n_pad: int, l_pad: int, w_pad: int | None, on_card: bool) -> str:
    """Aggregation mode for one level (host-side, shape-only).

    `w_pad` is the level-0 ELL tile width, or None on coarse levels where
    the tiles no longer describe the graph.  Without an override, `ell` is
    taken only on a card, where the histogram is the CUDA kernel.
    """
    if MODE_OVERRIDE is not None:
        if MODE_OVERRIDE != "ell":
            return MODE_OVERRIDE
        if w_pad is not None:
            return "ell"  # coarse levels fall through to the shape rules
    elif (w_pad is not None and on_card and w_pad <= ELL_WIDTH_CAP
          and n_pad * max(w_pad, l_pad) <= ELL_VOLUME_CAP):
        return "ell"
    if n_pad * l_pad <= DENSE_VOLUME_CAP:
        return "dense"
    return "sort"


def multilevel_partition_torch(
    g: CSRGraph,
    pinned: np.ndarray,
    p: FennelParams,
    loads_base: np.ndarray,
    cfg,
) -> np.ndarray:
    """Drop-in `multilevel_partition` with the V-cycle resident on
    `cfg.device`.  `cfg` is a MultilevelConfig (not imported, to avoid a
    module cycle with multilevel.py).  Each stage is a `vcycle.*` span of
    `repro_torch.tracing`."""
    with tracing.span("vcycle.run"):
        return _vcycle(g, pinned, p, loads_base, cfg)


def _sync_int(t: torch.Tensor) -> int:
    """int(t) of a 0-d device tensor: the host waits there for the card's
    queue, so it is a `vcycle.sync` span."""
    with tracing.span("vcycle.sync"):
        return int(t)


def _pack(g: CSRGraph, pinned: np.ndarray, n_pad: int, e_pad: int, w_pad: int | None,
          dev: torch.device):
    """The level-0 buffers (esrc, edst, ew, node_w, pin, nbr, wts) on `dev`,
    written by `csr_pack` from the compact CSR in one block; nbr and wts
    are None without `w_pad`.  On a card the block is pinned and sent with
    one non-blocking copy, and the kernel writes the padding; it is taken
    from PyTorch's caching host allocator for each call (the shard pool's
    threads pack at once), which reuses it only once the copy that read it
    has finished.  On the CPU the plain version reads the block in place."""
    n, e = g.n, int(g.indices.size)
    on_card = dev.type == "cuda"
    host = torch.empty(compact_layout(n, e)[1], dtype=torch.uint8, pin_memory=on_card)
    for view, a in zip(compact_views(host, n, e),
                       (g.indptr, g.indices, g.edge_w, g.node_w, pinned)):
        np.copyto(view.numpy(), a)
    tracing.add("h2d_bytes", host.numel())
    # the outputs before the upload's device block: that block, freed on
    # return, goes back into the free block it was cut from, so the caching
    # allocator is left as the same buffers uploaded padded would leave it
    out = pack_outputs(n_pad, e_pad, w_pad, dev)
    block = host.to(dev, non_blocking=True)
    csr_pack(*compact_views(block, n, e), n_pad, e_pad, w_pad, out=out)
    if on_card:
        tracing.add("pack_kernel", 1)
    return out


def _vcycle(g: CSRGraph, pinned: np.ndarray, p: FennelParams, loads_base: np.ndarray,
            cfg) -> np.ndarray:
    dev = resolve_device(cfg.device)
    on_card = dev.type == "cuda"

    def sync() -> None:
        if on_card:
            with tracing.span("vcycle.sync"):
                torch.cuda.synchronize(dev)

    def to_dev(a: np.ndarray) -> torch.Tensor:
        # a pageable copy, which waits for the card's queue as well: counted
        # in bytes, not as a `vcycle.sync`
        a = np.ascontiguousarray(a)
        tracing.add("h2d_bytes", a.nbytes)
        return torch.from_numpy(a).to(dev)

    autotune = bool(cfg.agg_autotune)

    def tuned(phase: str, np_l: int, l_pad: int, base: str):
        """(mode, timing key | None): the key is set while the tuner still
        wants a synchronized measurement of this call."""
        if (not autotune or MODE_OVERRIDE is not None or base == "ell"
                or np_l * l_pad > _AUTOTUNE_DENSE_CAP):
            return base, None
        key = (phase, np_l, l_pad)
        mode, explore = _TUNER.choose(key, ("dense", "sort"))
        return mode, (key if explore else None)

    def cluster_mode(level: int, np_l: int):
        return tuned("cluster", np_l, np_l,
                     _pick_mode(np_l, np_l, w_pad if level == 0 else None, on_card))

    def refine_mode(level: int, np_l: int):
        return tuned("refine", np_l, p.k,
                     _pick_mode(np_l, p.k, w_pad if level == 0 else None, on_card))

    def timed(key, fn, *args, **kw):
        """fn(*args, **kw), synchronized and recorded when `key` is set."""
        if key is None:
            return fn(*args, **kw)
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        sync()
        _TUNER.record(key, kw["mode"], time.perf_counter() - t0)
        return out

    with tracing.span("vcycle.pack"):
        n = g.n
        # floored at the block count: refine's capacity vector and accept's
        # target domain live in node-padded arrays
        n_pad = bucket_size(max(n, p.k))
        # edge bucket floored at 8·n_pad (capped) so batch-to-batch edge-count
        # noise maps onto one shape
        e_pad = bucket_size(int(g.indices.size), minimum=min(8 * n_pad, 2048))

        free_total = pinned < 0
        n_free = int(free_total.sum())
        total_free_w = float(g.node_w[free_total].astype(np.float64).sum())
        max_cluster_w = max(total_free_w / max(2 * p.k, 16),
                            float(g.node_w.max(initial=1.0)))

        # level 0 may use the ELL tiles packed once per batch; free-node
        # degrees bound the width (pinned aux rows never move, so their
        # truncation is harmless)
        free_deg = int(np.max(np.diff(g.indptr)[free_total], initial=1))
        w_pad = bucket_size(free_deg, minimum=8)
        tiled = "ell" in (cluster_mode(0, n_pad)[0], refine_mode(0, n_pad)[0])

        esrc, edst, ew, node_w, pin, nbr, wts = _pack(
            g, pinned, n_pad, e_pad, w_pad if tiled else None, dev)

        dummy_nbr = torch.zeros((1, 8), dtype=torch.int64, device=dev)
        dummy_wts = torch.zeros((1, 8), dtype=torch.float32, device=dev)
        if not tiled:
            nbr, wts = dummy_nbr, dummy_wts

    def tiles(level: int):
        return (nbr, wts) if level == 0 else (dummy_nbr, dummy_wts)

    # ---- coarsen (level loop on host; arrays stay on the device)
    levels: list[tuple] = []
    cur = (esrc, edst, ew, node_w, pin)
    cur_n, cur_free = n, n_free
    cur_np, cur_ep = n_pad, e_pad
    level = 0
    for _ in range(cfg.max_levels):
        if cur_free <= cfg.coarsen_target:
            break
        with tracing.span("vcycle.coarsen"):
            c_mode, c_key = cluster_mode(level, cur_np)
            lvl_nbr, lvl_wts = tiles(level)
            cluster = timed(c_key, _lp_cluster,
                            cur[0], cur[1], cur[2], lvl_nbr, lvl_wts, cur[3], cur[4],
                            cur_n, max_cluster_w, iters=cfg.lp_iters, mode=c_mode)
            es2, ed2, ew2, cw2, cpin2, node_map, nc_dev, ne_dev = _contract(
                cur[0], cur[1], cur[2], cluster, cur[3], cur[4], cur_n)
            nc = _sync_int(nc_dev)
            if nc >= cfg.min_shrink * cur_n:
                break
            levels.append((cur, cur_n, node_map, level))
            # re-bucket: coarse levels shrink geometrically, so slicing the
            # front-compacted buffers keeps per-level cost shrinking with them.
            # Old sentinels (= old n_pad) stay recognizable: >= the new pad.
            new_np = max(bucket_size(max(nc, p.k)), 64)
            new_ep = bucket_size(_sync_int(ne_dev), minimum=min(8 * new_np, 2048))
            new_ep = min(new_ep, cur_ep)
            es2, ed2, ew2 = es2[:new_ep], ed2[:new_ep], ew2[:new_ep]
            cw2, cpin2 = cw2[:new_np], cpin2[:new_np]
            cur = (es2, ed2, ew2, cw2, cpin2)
            cur_n = nc
            cur_np, cur_ep = new_np, new_ep
            cur_free = _sync_int(((cpin2 == -1) & (torch.arange(cur_np, device=dev) < nc)).sum())
            level += 1

    # ---- initial partition on the coarsest level
    with tracing.span("vcycle.initial"):
        # w_c covers FREE nodes only (fennel never slices a pinned row)
        if level == 0:
            max_deg = free_deg
        else:
            # on a card bincount reads its input's min and max on the host
            with tracing.span("vcycle.sync"):
                cnt = torch.bincount(cur[0].clamp(max=cur_np), minlength=cur_np + 1)
            free_c = (cur[4] == -1) & (torch.arange(cur_np, device=dev) < cur_n)
            max_deg = max(_sync_int(torch.where(free_c, cnt[:cur_np], 0).max()), 1)
        w_c = min(bucket_size(max_deg, minimum=64), cur_ep)
        labels, loads = _initial_fennel(
            cur[0], cur[1], cur[2], cur[3], cur[4], cur_n, cur_free,
            to_dev(np.asarray(loads_base, dtype=np.float64)),
            p.alpha, p.gamma, p.cap, w_c=w_c)
    with tracing.span("vcycle.refine"):
        r_mode, r_key = refine_mode(level, cur_np)
        lvl_nbr, lvl_wts = tiles(level)
        labels, loads = timed(r_key, _lp_refine,
                              cur[0], cur[1], cur[2], lvl_nbr, lvl_wts, cur[3], cur[4],
                              cur_n, labels, loads, p.cap, rounds=cfg.refine_rounds,
                              mode=r_mode)

    # ---- uncoarsen + refine
    for fine, fine_n, node_map, lvl in reversed(levels):
        with tracing.span("vcycle.refine"):
            labels = _project(labels, node_map, fine[4])
            r_mode, r_key = refine_mode(lvl, fine[3].shape[0])
            lvl_nbr, lvl_wts = tiles(lvl)
            labels, loads = timed(r_key, _lp_refine,
                                  fine[0], fine[1], fine[2], lvl_nbr, lvl_wts, fine[3],
                                  fine[4], fine_n, labels, loads, p.cap,
                                  rounds=cfg.refine_rounds, mode=r_mode)

    # the single device->host transfer of the batch assignment
    with tracing.span("vcycle.fetch"), tracing.span("vcycle.sync"):
        return labels[:n].cpu().numpy()
