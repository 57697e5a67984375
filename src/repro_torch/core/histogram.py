"""Neighbor-label histogram engines of the host V-cycle.

sparse path (`neighbor_label_weights`)
    Composite-key `np.bincount` over compacted labels: key = src·L + lab′,
    O(m + n·L); O(m) when every label is distinct (the CSR is then already
    the histogram); sort-aggregation above `dense_cap`.
    `sorted_neighbor_label_weights` is the O(m log m) argsort formulation
    it replaced, kept as the baseline.

dense/ELL path (`label_histogram_ell`)
    Packs neighbor labels into the padded ELL layout and runs the port's
    `block_histogram` on `device` — the CUDA kernel on a card, its plain
    version on the CPU.  Returns the dense (n, L) count matrix.

best-move selection (`best_label_per_src`)
    Segment maxima over the sparse triplets; ties break toward the lower
    label.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.graphs.csr import CSRGraph

if TYPE_CHECKING:
    import torch

# n·L ceiling for the dense-bincount scratch (8 MiB of float64 per 2^20)
DENSE_KEYSPACE_CAP = 1 << 24


def compact_labels(labels: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Map label values to 0..L-1 preserving order; returns (labc, uniq).

    `uniq` is ascending, so argmax tie-breaks over compact ids match "lower
    raw label wins"."""
    uniq, labc = np.unique(labels, return_inverse=True)
    return labc.astype(np.int64), uniq


def _edge_src(g: CSRGraph) -> np.ndarray:
    return np.repeat(np.arange(g.n, dtype=np.int64), np.diff(g.indptr))


def dense_key_ok(keyspace: int, n_entries: int, cap: int = DENSE_KEYSPACE_CAP) -> bool:
    """Dense bincount scratch pays off only while it stays O(entries)."""
    return keyspace <= min(max(4 * n_entries, 1 << 16), cap)


def aggregate_by_key(
    key: np.ndarray, w: np.ndarray, keyspace: int, cap: int = DENSE_KEYSPACE_CAP
) -> tuple[np.ndarray, np.ndarray]:
    """Sum float64 `w` per composite key; returns (unique keys asc, sums).

    Dense bincount when `dense_key_ok`, sort + reduceat otherwise; exact
    zero sums are dropped on both paths."""
    if key.size == 0:
        return np.empty(0, dtype=np.int64), np.empty(0)
    if dense_key_ok(keyspace, key.size, cap):
        sums = np.bincount(key, weights=w, minlength=keyspace)
        uk = np.nonzero(sums)[0]
        return uk, sums[uk]
    order = np.argsort(key, kind="stable")
    key_s, w_s = key[order], w[order]
    boundary = np.ones(key_s.shape[0], dtype=bool)
    boundary[1:] = key_s[1:] != key_s[:-1]
    starts = np.nonzero(boundary)[0]
    sums = np.add.reduceat(w_s, starts)
    uk = key_s[starts]
    keep = sums != 0
    return uk[keep], sums[keep]


def sorted_neighbor_label_weights(
    g: CSRGraph, labels: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The O(m log m) sort-aggregation formulation (argsort + reduceat):
    the seed's baseline, equal to `neighbor_label_weights`.  Labels are
    compacted first so the composite key never collides or overflows for
    arbitrary label values."""
    if g.indices.size == 0:
        e = np.empty(0, dtype=np.int64)
        return e, e.copy(), np.empty(0)
    labc, uniq = compact_labels(labels)
    L = np.int64(uniq.shape[0])
    src = _edge_src(g)
    key = src * L + labc[g.indices.astype(np.int64)]
    order = np.argsort(key, kind="stable")
    key_s, w_s = key[order], g.edge_w[order]
    boundary = np.ones(key_s.shape[0], dtype=bool)
    boundary[1:] = key_s[1:] != key_s[:-1]
    starts = np.nonzero(boundary)[0]
    sums = np.add.reduceat(w_s.astype(np.float64), starts)
    uk = key_s[starts]
    keep = sums != 0  # match the engine's zero-drop
    return uk[keep] // L, uniq[uk[keep] % L], sums[keep]


def neighbor_label_weights(
    g: CSRGraph,
    labels: np.ndarray,
    *,
    dense_cap: int = DENSE_KEYSPACE_CAP,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sparse per-(node, neighbor-label) weight sums: (src, lab, wsum)."""
    n = g.n
    if g.indices.size == 0:
        e = np.empty(0, dtype=np.int64)
        return e, e.copy(), np.empty(0)
    labc_node, uniq = compact_labels(labels)
    L = uniq.shape[0]
    if L == n:
        # all labels distinct: no two entries of a node's neighbor list
        # share a label (simple graph) — the CSR is already the histogram
        src = _edge_src(g)
        lab = labels[g.indices.astype(np.int64)]
        w = g.edge_w.astype(np.float64)
        keep = w != 0
        return src[keep], lab[keep], w[keep]
    src = _edge_src(g)
    labc = labc_node[g.indices.astype(np.int64)]
    key = src * np.int64(L) + labc
    uk, sums = aggregate_by_key(key, g.edge_w.astype(np.float64), n * L, dense_cap)
    return uk // L, uniq[uk % L], sums


def best_label_per_src(
    src: np.ndarray,
    lab: np.ndarray,
    wsum: np.ndarray,
    n: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-src (max weight, tie -> lower label) over src-grouped triplets.

    Returns (movers, targets, gains) for srcs holding >= 1 triplet."""
    if src.size == 0:
        e = np.empty(0, dtype=np.int64)
        return e, e.copy(), np.empty(0)
    seg = np.ones(src.size, dtype=bool)
    seg[1:] = src[1:] != src[:-1]
    starts = np.nonzero(seg)[0]
    movers = src[starts]
    gains = np.maximum.reduceat(wsum, starts)
    seg_len = np.diff(np.append(starts, src.size))
    is_best = wsum == np.repeat(gains, seg_len)
    lab_masked = np.where(is_best, lab, np.iinfo(np.int64).max)
    targets = np.minimum.reduceat(lab_masked, starts)
    return movers, targets, gains


def label_histogram_ell(
    g: CSRGraph, labels: np.ndarray, *, device: str | torch.device = "cuda"
) -> tuple[np.ndarray, np.ndarray]:
    """Dense (n, L) neighbor-label count matrix through `block_histogram`.

    Returns (counts, uniq) with counts[i, j] = summed weight from node i to
    label uniq[j] (float32, the kernel's accumulator type)."""
    import torch  # deferred: keeps torch off the sparse-only import path

    from repro_torch.kernels.ell_histogram import block_histogram

    dev = resolve_device(device)
    labc_node, uniq = compact_labels(labels)
    nbr, wts, mask = g.to_ell_padded()
    nbr_lab = np.where(mask, labc_node[np.where(mask, nbr, 0)], -1).astype(np.int32)
    counts = block_histogram(
        torch.from_numpy(nbr_lab).to(dev), torch.from_numpy(wts).to(dev), uniq.shape[0]
    )
    return counts[: g.n].cpu().numpy(), uniq
