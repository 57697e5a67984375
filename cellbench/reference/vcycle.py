"""Plain numpy reference of the batch V-cycle (BuffCut paper §3.4, after
HeiStream): size-constrained label-propagation clustering and contraction
down to `coarsen_target` free nodes, a sequential weighted Fennel sweep on
the coarsest graph, and balanced label-propagation refinement on the way
back up.  Written from the algorithm's rules, not from the program:

- a node's best label is the heaviest neighbouring label other than its
  own, ties to the lower label;
- moves into one target are taken by falling gain, ties by node id,
  while their summed weight fits the target's room;
- the sweep takes free nodes by falling weight, ties by id, and puts each
  in the feasible block of best score w(N(v) ∩ V_i) - αγ·c(V_i)^(γ-1),
  ties to the lower block, or in the first least-loaded block when no
  block is feasible.

Loads and gains are float64.  A cap of infinity lifts the balance cap
L_max everywhere: that is the control, which breaks the configuration's
balance guarantee.
"""
from __future__ import annotations

import math

import numpy as np


class Level:
    """A CSR graph with node weights and pinned blocks (-1 for free)."""

    def __init__(self, indptr, indices, edge_w, node_w, pinned):
        self.indptr = indptr
        self.indices = indices
        self.edge_w = edge_w
        self.node_w = node_w
        self.pinned = pinned

    @property
    def n(self) -> int:
        return int(self.indptr.shape[0] - 1)

    def rows(self) -> np.ndarray:
        return np.repeat(np.arange(self.n, dtype=np.int64), np.diff(self.indptr))


def csr(n: int, src: np.ndarray, dst: np.ndarray, w: np.ndarray):
    """Symmetric CSR from unique undirected edges src < dst."""
    rows = np.concatenate([src, dst])
    cols = np.concatenate([dst, src])
    ws = np.concatenate([w, w])
    order = np.lexsort((cols, rows))
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return indptr, cols[order], ws[order]


def best_moves(lv: Level, labels: np.ndarray, forbidden: np.ndarray | None = None):
    """Per node with a neighbouring label other than its own (and not
    forbidden): (nodes, best label, its weight), and every node's weight
    to its own label."""
    src = lv.rows()
    lab = labels[lv.indices]
    w = lv.edge_w.astype(np.float64)
    base = np.int64(labels.max(initial=0)) + 2
    key = src * base + (lab + 1)  # labels >= -1
    uk, inv = np.unique(key, return_inverse=True)
    wsum = np.bincount(inv, weights=w, minlength=uk.shape[0])
    s, lb = uk // base, uk % base - 1
    own = lb == labels[s]
    cur = np.zeros(lv.n, dtype=np.float64)
    cur[s[own]] = wsum[own]
    keep = ~own & (wsum != 0) & (lb >= 0)
    if forbidden is not None:
        keep &= ~forbidden[np.maximum(lb, 0)]
    s, lb, wsum = s[keep], lb[keep], wsum[keep]
    if s.size == 0:
        e = np.empty(0, dtype=np.int64)
        return e, e.copy(), np.empty(0), cur
    # heaviest first, then the lower label: the first entry of each node
    order = np.lexsort((lb, -wsum, s))
    s, lb, wsum = s[order], lb[order], wsum[order]
    first = np.ones(s.shape[0], dtype=bool)
    first[1:] = s[1:] != s[:-1]
    return s[first], lb[first], wsum[first], cur


def accept(movers, targets, gains, node_w, room) -> np.ndarray:
    """Within each target, movers by falling gain (ties by node id) while
    their running weight fits the target's room."""
    if movers.size == 0:
        return np.zeros(0, dtype=bool)
    order = np.lexsort((movers, -gains, targets))
    t = targets[order]
    w = node_w[movers[order]].astype(np.float64)
    first = np.ones(t.shape[0], dtype=bool)
    first[1:] = t[1:] != t[:-1]
    total = np.cumsum(w)
    before = np.where(first, total - w, 0.0)
    np.maximum.accumulate(before, out=before)
    ok = np.zeros(movers.shape[0], dtype=bool)
    ok[order] = total - before <= room[t] + 1e-9
    return ok


def cluster(lv: Level, max_w: float, iters: int) -> np.ndarray:
    """Size-constrained LP clustering; pinned nodes stay alone."""
    labels = np.arange(lv.n, dtype=np.int64)
    pinned = lv.pinned >= 0
    cw = lv.node_w.astype(np.float64).copy()
    for _ in range(iters):
        movers, targets, gains, _ = best_moves(lv, labels, forbidden=pinned)
        free = ~pinned[movers]
        movers, targets, gains = movers[free], targets[free], gains[free]
        fit = cw[targets] + lv.node_w[movers] <= max_w
        movers, targets, gains = movers[fit], targets[fit], gains[fit]
        if movers.size == 0:
            break
        room = np.maximum(max_w - cw, 0.0)
        ok = accept(movers, targets, gains, lv.node_w, room)
        movers, targets = movers[ok], targets[ok]
        if movers.size == 0:
            break
        np.subtract.at(cw, labels[movers], lv.node_w[movers].astype(np.float64))
        labels[movers] = targets
        np.add.at(cw, targets, lv.node_w[movers].astype(np.float64))
    return labels


def contract(lv: Level, labels: np.ndarray) -> tuple[Level, np.ndarray]:
    """One coarse node per cluster, numbered by the clusters' ids."""
    uniq, node_map = np.unique(labels, return_inverse=True)
    nc = uniq.shape[0]
    cw = np.bincount(node_map, weights=lv.node_w.astype(np.float64), minlength=nc)
    cpin = np.full(nc, -1, dtype=np.int64)
    pm = lv.pinned >= 0
    cpin[node_map[pm]] = lv.pinned[pm]
    s = node_map[lv.rows()]
    d = node_map[lv.indices]
    keep = s < d
    key = s[keep] * np.int64(nc) + d[keep]
    uk, inv = np.unique(key, return_inverse=True)
    sums = np.bincount(inv, weights=lv.edge_w[keep].astype(np.float64), minlength=uk.shape[0])
    nz = sums != 0
    uk, sums = uk[nz], sums[nz]
    indptr, indices, ew = csr(nc, uk // nc, uk % nc, sums.astype(np.float32))
    return Level(indptr, indices, ew, cw.astype(np.float32), cpin), node_map


def fennel_sweep(lv: Level, loads: np.ndarray, k: int, alpha: float, gamma: float,
                 cap: float) -> np.ndarray:
    """Sequential weighted Fennel over the free nodes, heaviest first."""
    labels = lv.pinned.copy()
    free = np.nonzero(lv.pinned < 0)[0]
    order = free[np.lexsort((free, -lv.node_w[free]))].tolist()
    ag = alpha * gamma
    g1 = gamma - 1.0
    powf = math.sqrt if g1 == 0.5 else (lambda x: float(np.power(x, g1)))
    lab = labels.tolist()
    ld = [float(x) for x in loads]
    ip = lv.indptr.tolist()
    idx = lv.indices.tolist()
    ew = lv.edge_w.astype(np.float64).tolist()
    nws = lv.node_w.astype(np.float64).tolist()
    blocks = range(k)
    for v in order:
        conn = [0.0] * k
        for j in range(ip[v], ip[v + 1]):
            b = lab[idx[j]]
            if b >= 0:
                conn[b] += ew[j]
        nw = nws[v]
        best, best_s = -1, -math.inf
        for i in blocks:
            li = ld[i]
            if li + nw > cap:
                continue
            s = conn[i] - ag * powf(li if li > 0.0 else 0.0)
            if s > best_s:
                best, best_s = i, s
        if best < 0:
            best = ld.index(min(ld))
        lab[v] = best
        ld[best] += nw
    return np.asarray(lab, dtype=np.int64)


def refine(lv: Level, labels: np.ndarray, loads: np.ndarray, cap: float, rounds: int):
    """Balanced synchronous LP refinement: free nodes move to their best
    block when the gain is positive and the block's room holds them."""
    labels = labels.copy()
    loads = loads.copy()
    free = lv.pinned < 0
    for _ in range(rounds):
        movers, targets, best_w, cur = best_moves(lv, labels)
        gains = best_w - cur[movers]
        ok = free[movers] & (gains > 1e-12)
        movers, targets, gains = movers[ok], targets[ok], gains[ok]
        if movers.size == 0:
            break
        room = np.maximum(cap - loads, 0.0)
        acc = accept(movers, targets, gains, lv.node_w, room)
        movers, targets = movers[acc], targets[acc]
        if movers.size == 0:
            break
        w = lv.node_w[movers].astype(np.float64)
        np.subtract.at(loads, labels[movers], w)
        labels[movers] = targets
        np.add.at(loads, targets, w)
    return labels, loads


def vcycle(lv: Level, loads_base: np.ndarray, *, k: int, alpha: float, gamma: float,
           cap: float, ml: dict) -> np.ndarray:
    """A label per node of the batch model `lv`; `loads_base` are the blocks'
    global loads before the batch."""
    free = lv.pinned < 0
    total_free_w = float(lv.node_w[free].astype(np.float64).sum())
    max_w = max(total_free_w / max(2 * k, 16), float(lv.node_w.max(initial=1.0)))
    levels = []
    cur = lv
    for _ in range(int(ml["max_levels"])):
        if int((cur.pinned < 0).sum()) <= int(ml["coarsen_target"]):
            break
        coarse, node_map = contract(cur, cluster(cur, max_w, int(ml["lp_iters"])))
        if coarse.n >= float(ml["min_shrink"]) * cur.n:
            break
        levels.append((cur, node_map))
        cur = coarse
    labels = fennel_sweep(cur, loads_base, k, alpha, gamma, cap)
    loads = loads_base.astype(np.float64).copy()
    fr = cur.pinned < 0
    np.add.at(loads, labels[fr], cur.node_w[fr].astype(np.float64))
    rounds = int(ml["refine_rounds"])
    labels, loads = refine(cur, labels, loads, cap, rounds)
    for fine, node_map in reversed(levels):
        labels = labels[node_map]
        pin = fine.pinned >= 0
        labels[pin] = fine.pinned[pin]
        labels, loads = refine(fine, labels, loads, cap, rounds)
    return labels
