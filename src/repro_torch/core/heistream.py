"""HeiStream baseline [Faraj & Schulz, JEA'22]: buffered streaming with
*contiguous* batches (no priority buffer).  Loads δ nodes in stream order,
partitions the batch model graph with the same multilevel scheme, commits,
repeats.  This is the ablation isolating BuffCut's prioritized buffering:
the only difference from the sequential driver is batch composition.

With `cfg.ml.engine` "torch" on a card, every batch is one V-cycle on the
card (one `fennel_sweep` launch, `ell_histogram` launches), as in the
BuffCut drivers; there is no host fallback.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core._deprecation import require_csr, warn_legacy
from repro_torch.core.batch_model import build_batch_model
from repro_torch.core.buffcut import BuffCutConfig, StreamStats
from repro_torch.core.fennel import FennelParams
from repro_torch.core.metrics import internal_edge_ratio
from repro_torch.core.multilevel import multilevel_partition
from repro_torch.device import preflight
from repro_torch.graphs.csr import CSRGraph


def heistream_partition(
    g: CSRGraph, cfg: BuffCutConfig
) -> tuple[np.ndarray, StreamStats]:
    """Deprecated shim: `repro_torch.api.partition` is the front door.
    Checks the device (and builds the kernels on a card) first, as the
    BuffCut drivers do."""
    warn_legacy("heistream_partition(g, cfg)", "partition(g, driver='heistream', k=...)")
    if cfg.ml.engine != "sparse":
        preflight(cfg.ml.device)
    return _heistream_partition(g, cfg)


def _heistream_partition(
    g: CSRGraph, cfg: BuffCutConfig
) -> tuple[np.ndarray, StreamStats]:
    g = require_csr(g, "heistream")
    p = FennelParams(
        k=cfg.k,
        n_total=float(g.node_w.astype(np.float64).sum()),
        m_total=g.total_edge_weight(),
        eps=cfg.eps,
        gamma=cfg.gamma,
    )
    block = np.full(g.n, -1, dtype=np.int64)
    loads = np.zeros(cfg.k, dtype=np.float64)
    stats = StreamStats()
    t0 = time.perf_counter()
    for start in range(0, g.n, cfg.batch_size):
        bnodes = np.arange(start, min(start + cfg.batch_size, g.n), dtype=np.int64)
        model = build_batch_model(g, bnodes, block, cfg.k)
        t_ml = time.perf_counter()
        labels = multilevel_partition(model.graph, model.pinned_block, p, loads, cfg.ml)
        stats.ml_time_s += time.perf_counter() - t_ml
        block[bnodes] = labels[: bnodes.shape[0]]
        np.add.at(loads, labels[: bnodes.shape[0]], g.node_w[bnodes].astype(np.float64))
        stats.n_batches += 1
        if cfg.collect_stats:
            stats.ier_per_batch.append(internal_edge_ratio(g, bnodes))
            stats.peak_mem_items = max(
                stats.peak_mem_items, len(bnodes) + model.graph.indices.shape[0]
            )
    stats.runtime_s = time.perf_counter() - t0
    return block, stats
