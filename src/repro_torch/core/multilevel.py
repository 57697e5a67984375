"""Multilevel partitioning of the batch model graph (paper §3.4).

Scheme (HeiStream's, vectorized for data-parallel hardware — DESIGN.md §3):
  coarsen:  size-constrained label-propagation clustering + contraction,
  initial:  weighted Fennel on the coarsest graph (aux nodes pre-pinned),
  refine:   balanced label-propagation refinement during uncoarsening.

Engines:
  sparse  host numpy bincount histograms,
  ell     host V-cycle with the neighbor-label histogram on `device`
          (the CUDA `ell_histogram` kernel on a card),
  torch   the whole V-cycle resident on `device` (core/multilevel_torch.py),
  auto    `ell` on a CUDA device within the ELL tile caps, else `sparse`.
Every engine gives the same labels (pinned against `repro`'s sparse
engine on integer-weight graphs).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.fennel import FennelParams
from repro_torch.core.histogram import (
    aggregate_by_key,
    best_label_per_src,
    label_histogram_ell,
    neighbor_label_weights,
)
from repro_torch.graphs.csr import CSRGraph

# ELL dense-path ceilings: padded tile volume and max padded row width
_ELL_VOLUME_CAP = 1 << 24
_ELL_WIDTH_CAP = 4096

_ENGINES = ("auto", "sparse", "ell", "torch")


@dataclasses.dataclass
class MultilevelConfig:
    coarsen_target: int = 160      # free-node count target at coarsest level
    max_levels: int = 10
    lp_iters: int = 2              # clustering iterations per level
    refine_rounds: int = 3         # LP refinement rounds per level
    min_shrink: float = 0.95       # stop coarsening if shrink factor above
    seed: int = 0
    engine: str = "auto"           # "auto" | "sparse" | "ell" | "torch"
    # torch engine only: measured-time aggregation-mode selection per
    # (phase, level shape), see multilevel_torch._AggTuner; labels are
    # unaffected (cross-mode parity)
    agg_autotune: bool = False
    device: str = "cuda"           # where "ell", "torch" and "auto" run

    def __post_init__(self) -> None:
        if self.engine not in _ENGINES:
            raise ValueError(
                f"unknown multilevel engine {self.engine!r}: pick one of "
                f"{_ENGINES} ('auto' dispatches sparse/ell by device and "
                "shape, 'torch' is the device-resident V-cycle)"
            )
        if self.coarsen_target < 1:
            raise ValueError(
                f"MultilevelConfig.coarsen_target must be >= 1, got {self.coarsen_target}"
            )
        if self.max_levels < 1:
            raise ValueError(
                f"MultilevelConfig.max_levels must be >= 1, got {self.max_levels}"
            )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "MultilevelConfig":
        return cls(**d)


def _resolve_engine(engine: str, g: CSRGraph, device: str) -> str:
    """auto -> ELL tiles through the histogram kernel on a CUDA device
    (within the tile caps), sparse bincount elsewhere.  "torch" selects the
    device engine at the multilevel_partition level; the host helpers below
    resolve it to "sparse" so they stay directly callable."""
    if engine in ("sparse", "ell"):
        return engine
    if engine == "torch":
        return "sparse"
    if engine != "auto":
        raise ValueError(f"unknown multilevel engine {engine!r}")
    if not str(device).startswith("cuda"):
        return "sparse"
    w_pad = max(8, ((g.max_degree + 7) // 8) * 8)
    if w_pad > _ELL_WIDTH_CAP or g.n * w_pad > _ELL_VOLUME_CAP:
        return "sparse"
    return "ell"


def _best_moves(
    g: CSRGraph,
    labels: np.ndarray,
    engine: str,
    device: str,
    *,
    forbidden_label: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per node: heaviest neighbor label != own (ties -> lower label).

    Returns (movers, targets, gain_w, cur_conn): nodes with at least one
    eligible neighbor label, their best label and its weight, and the dense
    (n,) weight to each node's own label.  `forbidden_label` masks labels
    that may never be targets."""
    n = g.n
    if engine == "ell":
        counts, uniq = label_histogram_ell(g, labels, device=device)
        counts = counts.astype(np.float64)
        own_col = np.searchsorted(uniq, labels)
        rows = np.arange(n)
        cur_conn = counts[rows, own_col].copy()
        if forbidden_label is not None:
            counts[:, forbidden_label[uniq]] = -np.inf
        counts[rows, own_col] = -np.inf
        best_col = np.argmax(counts, axis=1)
        gain_w = counts[rows, best_col]
        movers = np.nonzero(gain_w > 0.0)[0]
        return movers, uniq[best_col[movers]], gain_w[movers], cur_conn
    src, lab, wsum = neighbor_label_weights(g, labels)
    cur_conn = np.zeros(n, dtype=np.float64)
    is_cur = lab == labels[src]
    cur_conn[src[is_cur]] = wsum[is_cur]
    keep = ~is_cur
    if forbidden_label is not None:
        keep &= ~forbidden_label[lab]
    movers, targets, gain_w = best_label_per_src(src[keep], lab[keep], wsum[keep], n)
    return movers, targets, gain_w, cur_conn


def _accept_with_capacity(
    movers: np.ndarray,
    targets: np.ndarray,
    gains: np.ndarray,
    node_w: np.ndarray,
    capacity: np.ndarray,
) -> np.ndarray:
    """Greedy per-target acceptance: within each target, take movers in
    gain-descending order while their cumulative weight fits the remaining
    capacity.  Returns a boolean accept mask aligned with `movers`."""
    if movers.size == 0:
        return np.zeros(0, dtype=bool)
    order = np.lexsort((-gains, targets))  # by target, then gain desc
    m_s, t_s = movers[order], targets[order]
    w_s = node_w[m_s].astype(np.float64)
    grp_start = np.ones(t_s.shape[0], dtype=bool)
    grp_start[1:] = t_s[1:] != t_s[:-1]
    csum = np.cumsum(w_s)
    base = np.zeros_like(csum)
    starts = np.nonzero(grp_start)[0]
    base[starts] = csum[starts] - w_s[starts]
    np.maximum.accumulate(base, out=base)
    within = csum - base  # cumsum restarted at each group
    ok_s = within <= capacity[t_s] + 1e-9
    accept = np.zeros(movers.shape[0], dtype=bool)
    accept[order] = ok_s
    return accept


# --------------------------------------------------------------------------
# coarsening
# --------------------------------------------------------------------------

def lp_cluster(
    g: CSRGraph,
    pinned: np.ndarray,
    max_cluster_w: float,
    iters: int,
    engine: str = "auto",
    device: str = "cuda",
) -> np.ndarray:
    """Size-constrained label propagation clustering.  Pinned nodes stay
    singletons and free nodes never join them."""
    n = g.n
    cluster = np.arange(n, dtype=np.int64)
    is_pinned = pinned >= 0
    cw = g.node_w.astype(np.float64).copy()
    engine = _resolve_engine(engine, g, device)
    for _ in range(iters):
        movers, targets, gains, _ = _best_moves(
            g, cluster, engine, device, forbidden_label=is_pinned
        )
        free = ~is_pinned[movers]
        movers, targets, gains = movers[free], targets[free], gains[free]
        if movers.size == 0:
            break
        fit = cw[targets] + g.node_w[movers] <= max_cluster_w
        movers, targets, gains = movers[fit], targets[fit], gains[fit]
        capacity = np.maximum(max_cluster_w - cw, 0.0)
        acc = _accept_with_capacity(movers, targets, gains, g.node_w, capacity)
        movers, targets = movers[acc], targets[acc]
        if movers.size == 0:
            break
        np.add.at(cw, cluster[movers], -g.node_w[movers].astype(np.float64))
        cluster[movers] = targets
        np.add.at(cw, targets, g.node_w[movers].astype(np.float64))
    return cluster


def contract(
    g: CSRGraph, cluster: np.ndarray, pinned: np.ndarray
) -> tuple[CSRGraph, np.ndarray, np.ndarray]:
    """Contract clusters; returns (coarse graph, coarse pinned, node map)."""
    uniq, node_map = np.unique(cluster, return_inverse=True)
    nc = uniq.shape[0]
    cw = np.zeros(nc, dtype=np.float64)
    np.add.at(cw, node_map, g.node_w.astype(np.float64))
    cpin = np.full(nc, -1, dtype=np.int64)
    pm = pinned >= 0
    cpin[node_map[pm]] = pinned[pm]
    src = node_map[np.repeat(np.arange(g.n, dtype=np.int64), np.diff(g.indptr))]
    dst = node_map[g.indices.astype(np.int64)]
    keep = src < dst
    s, d, w = src[keep], dst[keep], g.edge_w[keep].astype(np.float64)
    uk, sums = aggregate_by_key(s * np.int64(nc) + d, w, nc * nc)
    edges = np.stack([uk // nc, uk % nc], axis=1)
    cg = CSRGraph.from_edges(nc, edges, edge_weights=sums.astype(np.float32),
                             node_weights=cw.astype(np.float32))
    return cg, cpin, node_map


# --------------------------------------------------------------------------
# initial partition + refinement
# --------------------------------------------------------------------------

def initial_fennel(
    g: CSRGraph,
    pinned: np.ndarray,
    p: FennelParams,
    loads: np.ndarray,
) -> np.ndarray:
    """Weighted Fennel on the coarsest graph, heaviest free nodes first,
    through the scalar host loop `fennel_gain_sequential`."""
    from repro_torch.kernels.fennel_gain import fennel_gain_sequential

    labels = pinned.copy()
    free = np.nonzero(pinned < 0)[0]
    order = free[np.lexsort((free, -g.node_w[free]))]
    loads = loads.copy()
    if order.size == 0:
        return labels
    fennel_gain_sequential(
        g.indptr, g.indices, g.edge_w, g.node_w, order, labels, loads,
        alpha=p.alpha, gamma=p.gamma, cap=p.cap, k=p.k,
    )
    return labels


def lp_refine(
    g: CSRGraph,
    labels: np.ndarray,
    pinned: np.ndarray,
    p: FennelParams,
    loads: np.ndarray,
    rounds: int,
    engine: str = "auto",
    device: str = "cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Balanced synchronous LP refinement: move to max-connectivity block if
    the cut gain is positive and the balance cap holds."""
    labels = labels.copy()
    loads = loads.copy()
    free = pinned < 0
    engine = _resolve_engine(engine, g, device)
    for _ in range(rounds):
        movers, targets, best_w, cur_conn = _best_moves(g, labels, engine, device)
        gains = best_w - cur_conn[movers]
        ok = free[movers] & (gains > 1e-12)
        movers, targets, gains = movers[ok], targets[ok], gains[ok]
        if movers.size == 0:
            break
        capacity = np.maximum(p.cap - loads, 0.0)
        acc = _accept_with_capacity(movers, targets, gains, g.node_w, capacity)
        movers, targets = movers[acc], targets[acc]
        if movers.size == 0:
            break
        np.add.at(loads, labels[movers], -g.node_w[movers].astype(np.float64))
        labels[movers] = targets
        np.add.at(loads, targets, g.node_w[movers].astype(np.float64))
    return labels, loads


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------

def multilevel_partition(
    g: CSRGraph,
    pinned: np.ndarray,
    p: FennelParams,
    loads_base: np.ndarray,
    cfg: MultilevelConfig | None = None,
) -> np.ndarray:
    """Partition the model graph; returns a label per local node.  Aux
    nodes keep their pinned labels; `loads_base` are the current global
    block loads (aux node weights are zero, see batch_model.py)."""
    cfg = cfg or MultilevelConfig()
    if cfg.engine == "torch":
        from repro_torch.core.multilevel_torch import multilevel_partition_torch

        return multilevel_partition_torch(g, pinned, p, loads_base, cfg)
    total_free_w = float(g.node_w[pinned < 0].astype(np.float64).sum())
    max_cluster_w = max(total_free_w / max(2 * p.k, 16), float(g.node_w.max(initial=1.0)))

    # ---- coarsen
    levels: list[tuple[CSRGraph, np.ndarray, np.ndarray]] = []  # (graph, pinned, map)
    cur_g, cur_pin = g, pinned
    for _ in range(cfg.max_levels):
        if int((cur_pin < 0).sum()) <= cfg.coarsen_target:
            break
        cluster = lp_cluster(cur_g, cur_pin, max_cluster_w, cfg.lp_iters,
                             engine=cfg.engine, device=cfg.device)
        cg, cpin, node_map = contract(cur_g, cluster, cur_pin)
        if cg.n >= cfg.min_shrink * cur_g.n:
            break
        levels.append((cur_g, cur_pin, node_map))
        cur_g, cur_pin = cg, cpin

    # ---- initial partition on the coarsest level
    labels = initial_fennel(cur_g, cur_pin, p, loads_base)
    loads = loads_base.copy()
    fr = cur_pin < 0
    np.add.at(loads, labels[fr], cur_g.node_w[fr].astype(np.float64))
    labels, loads = lp_refine(cur_g, labels, cur_pin, p, loads, cfg.refine_rounds,
                              engine=cfg.engine, device=cfg.device)

    # ---- uncoarsen + refine
    for fine_g, fine_pin, node_map in reversed(levels):
        labels = labels[node_map]
        labels[fine_pin >= 0] = fine_pin[fine_pin >= 0]
        labels, loads = lp_refine(fine_g, labels, fine_pin, p, loads,
                                  cfg.refine_rounds, engine=cfg.engine,
                                  device=cfg.device)
    return labels
