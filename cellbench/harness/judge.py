"""Decides `correct`: every job of the window against the plain reference.

Three numbers are compared, each against its limit:

- `label_mismatch`: nodes whose committed label differs from the
  reference's (or lies outside [0, k)), the most over the window's jobs;
  limit 0, as the program's V-cycle is exact on integer weights;
- `cut_gap`: the largest gap between the cut the program reports and
  the cut the reference counts from the program's labels; limit 0;
- `load_over_cap`: the heaviest block's load over the balance cap
  L_max = ceil((1 + eps) c(V) / k), the most over the jobs; limit 1, as
  the configuration states.
"""
from __future__ import annotations

import numpy as np

LIMITS = {"label_mismatch": 0, "cut_gap": 0.0, "load_over_cap": 1.0}


def edge_cut(graph, labels: np.ndarray) -> float:
    rows = np.repeat(np.arange(graph.n, dtype=np.int64), np.diff(graph.indptr))
    cols = graph.indices.astype(np.int64)
    cut = (rows < cols) & (labels[rows] != labels[cols])
    return float(graph.edge_w[cut].astype(np.float64).sum())


def judge(graph, want: np.ndarray, jobs: list, k: int, cap: float) -> tuple[dict, int]:
    """({name: {value, limit}}, jobs failed); each job is (labels, the
    program's reported cut)."""
    worst = {name: 0 for name in LIMITS}
    failed = 0
    for labels, reported_cut in jobs:
        labels = np.asarray(labels)
        bad = (labels.shape != want.shape) or bool(((labels < 0) | (labels >= k)).any())
        mismatch = graph.n if bad else int((labels != want).sum())
        if bad:  # past every limit, and still a number
            gap, over = float(graph.m), float(graph.n) / cap
        else:
            gap = abs(float(reported_cut) - edge_cut(graph, labels))
            loads = np.bincount(labels, weights=graph.node_w.astype(np.float64), minlength=k)
            over = float(loads.max()) / cap
        job = {"label_mismatch": mismatch, "cut_gap": gap, "load_over_cap": over}
        failed += any(job[n] > LIMITS[n] for n in LIMITS)
        worst = {n: max(worst[n], job[n]) for n in LIMITS}
    return {n: {"value": worst[n], "limit": LIMITS[n]} for n in LIMITS}, failed
