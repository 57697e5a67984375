"""`repro_torch.api`: the one front door to every partitioner of the port.

    from repro_torch.api import partition

    res = partition("graph.bcsr", k=16, driver="buffcut")        # flat kwargs
    res = partition(g, DriverConfig(driver="cuttana", ...))      # full config
    res = partition(g, k=16, device="cpu")                       # on the host
    res.cut_ratio, res.balance, res.ier                          # lazy metrics
    res.to_json("out.json")                                      # round-trips

Sources: `CSRGraph`, any `NodeStreamBase`, a path to METIS text or packed
binary (streamed out of core), or a generator spec like
``gen:grid:side=64``.  Drivers: everything in `list_partitioners()`
(registry.py); streaming drivers partition straight from disk, memory-only
baselines raise the standard actionable `TypeError` on disk streams.
Orderings are realized in memory via `apply_order`, or on disk via the
permute pass so the partitioning path stays out of core; labels always
come back in the *input* numbering.

The multilevel V-cycle runs on `ml.device` ("cuda" unless the caller asks
for "cpu"): `partition` checks the device, and on a card builds the
kernels, once before any work (`repro_torch.device.preflight`), for every
engine but "sparse".  A device error propagates; there is no host fallback.

The legacy per-driver functions remain importable but are deprecation
shims over this layer (bit-identity pinned in tests/test_torch_api.py).
CLI twin: ``python -m repro_torch partition <source> -k 16 --driver pipelined``.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import numpy as np

from repro_torch.api.config import (
    ORDERINGS,
    CuttanaConfig,
    DriverConfig,
    MultilevelConfig,
    PipelineConfig,
    VectorizedConfig,
)
from repro_torch.api.registry import (
    PartitionerSpec,
    get_partitioner,
    list_partitioners,
    register_partitioner,
)
from repro_torch.api.result import PartitionResult
from repro_torch.api.sources import ResolvedSource, resolve_source
from repro_torch.core.buffcut import BuffCutConfig, StreamStats
from repro_torch.core.checkpoint import CheckpointError, Checkpointer, load_checkpoint
from repro_torch.core.restream import restream_refine as _restream_refine
from repro_torch.device import preflight
from repro_torch.distributed.shard_driver import shard_partition as _shard_partition
from repro_torch.graphs.orderings import apply_order, bfs_order, konect_order
from repro_torch.graphs.stream import NodeStream
from repro_torch.graphs.stream_io import DiskNodeStream, permute_to_disk

__all__ = [
    "partition",
    "resume",
    "CheckpointError",
    "PartitionResult",
    "PartitionerSpec",
    "register_partitioner",
    "list_partitioners",
    "get_partitioner",
    "resolve_source",
    "ResolvedSource",
    "DriverConfig",
    "BuffCutConfig",
    "CuttanaConfig",
    "MultilevelConfig",
    "VectorizedConfig",
    "PipelineConfig",
    "ORDERINGS",
]


def _coerce_config(config, overrides: dict) -> DriverConfig:
    if config is None:
        return DriverConfig.create(**overrides)
    if isinstance(config, DriverConfig):
        return DriverConfig.create(config, **overrides) if overrides else config
    if isinstance(config, BuffCutConfig):  # includes CuttanaConfig
        return DriverConfig.create(DriverConfig(buffcut=config), **overrides)
    raise TypeError(
        f"config must be a DriverConfig or BuffCutConfig, got {type(config).__name__}"
    )


def _compute_perm(src: ResolvedSource, dc: DriverConfig) -> np.ndarray:
    if dc.ordering == "random":
        # identical to graphs.orderings.random_order, but needs only n —
        # disk sources stay out-of-core
        return np.random.default_rng(dc.order_seed).permutation(src.stream.n).astype(np.int64)
    g = src.graph if src.graph is not None else src.materialize()
    return bfs_order(g) if dc.ordering == "bfs" else konect_order(g, seed=dc.order_seed)


def _realize_ordering(
    src: ResolvedSource, dc: DriverConfig
) -> "tuple[ResolvedSource, np.ndarray | None, tempfile.TemporaryDirectory | None]":
    """Permute the source so streaming it reproduces `dc.ordering`.

    In-memory sources relabel via `apply_order`; disk sources go through the
    on-disk permute/shard pass (bit-identical, conformance-pinned) so the
    partitioning path never materializes the graph.  BFS/KONECT orderings
    need the structure to compute the permutation, so they materialize disk
    sources first; `random` does not.
    """
    if dc.ordering == "natural":
        return src, None, None
    perm = _compute_perm(src, dc)
    if src.graph is None and src.path is None:
        # foreign stream with no file behind it: the only way to reorder it
        src.materialize()
    if src.graph is not None:
        g2 = apply_order(src.graph, perm)
        return (
            ResolvedSource(NodeStream(g2), g2, src.kind, src.origin),
            perm,
            None,
        )
    tmp = tempfile.TemporaryDirectory(prefix="repro-ordering-")
    out = os.path.join(tmp.name, "ordered.bcsr")
    # preserve the source's tuned read-ahead window (memory-bound contract)
    chunk = getattr(src.stream, "io_chunk_bytes", None)
    kw = {} if chunk is None else {"io_chunk_bytes": chunk}
    permute_to_disk(src.path, perm, out, **kw)
    return (
        ResolvedSource(DiskNodeStream(out, **kw), None, src.kind, src.origin, path=out),
        perm,
        tmp,
    )


def partition(
    source,
    config: "DriverConfig | BuffCutConfig | None" = None,
    *,
    _resume_state: "dict | None" = None,
    **overrides,
) -> PartitionResult:
    """Partition `source` and return a `PartitionResult`.

    `config` is a `DriverConfig` (or a bare `BuffCutConfig`, wrapped);
    flat keyword overrides (``k=16, driver="pipelined", engine="torch",
    device="cpu", ordering="bfs", restream_passes=1, ...``) are routed by
    `DriverConfig.create`.  Labels are indexed by the input's node ids even
    when an ordering permutes the stream.

    With ``checkpoint_path`` set (``checkpoint_every`` batches per snapshot,
    default 8), the run is crash-safe: `repro_torch.api.resume` — or ``python -m
    repro_torch partition --resume <ckpt>`` — reopens the stream at the
    checkpointed byte offset and continues bit-identically.
    `_resume_state` is that internal handoff; use `resume()`.
    """
    dc = _coerce_config(config, overrides)
    spec = get_partitioner(dc.driver)
    if dc.workers > 1 and not spec.supports_shard:
        raise ValueError(
            f"driver {spec.name!r} does not support sharded multi-worker "
            "runs; shard-capable drivers: buffcut (or run workers=1)"
        )
    if dc.buffcut.ml.engine != "sparse":
        preflight(dc.buffcut.ml.device)  # once, before any work
    src = resolve_source(source)
    ckpt = None
    if dc.checkpoint_path:
        if not spec.supports_checkpoint:
            raise ValueError(
                f"driver {spec.name!r} does not support checkpointing; "
                "checkpoint-capable drivers: "
                "buffcut, buffcut-vec, buffcut-pipe"
            )
        ckpt = Checkpointer(dc.checkpoint_path, dc.checkpoint_every)
        # envelope merged into every snapshot so resume() can rebuild the
        # run from the file alone (in-memory sources can't be re-resolved;
        # resume() then requires an explicit source)
        source_spec = src.path if src.path is not None else (
            src.origin if src.kind == "generated" else None
        )
        ckpt.extra = {"api": {
            "driver_config_json": dc.to_json(),
            "source_spec": source_spec,
        }}
    rs = _resume_state
    if rs is not None and ckpt is None:
        raise ValueError(
            "resuming needs checkpointing enabled: set checkpoint_path "
            "(resume() carries it over from the checkpoint automatically)"
        )
    driver_resume = rs if rs is not None and rs.get("kind") != "restream" else None
    restream_resume = rs if rs is not None and rs.get("kind") == "restream" else None
    if restream_resume is not None and dc.restream_passes == 0:
        raise CheckpointError(
            "checkpoint was written during a restream pass but the resuming "
            "config has restream_passes=0"
        )
    run_src, perm, tmp = _realize_ordering(src, dc)
    if (
        (dc.restream_passes > 0 or dc.workers > 1)
        and run_src.graph is None
        and not isinstance(run_src.stream, DiskNodeStream)
    ):
        # restream and the shard split both replay the stream; a foreign
        # stream with no file behind it is not replayable, so load it up
        # front (before the first pass exhausts it).  NodeStream /
        # DiskNodeStream replay natively.
        g = run_src.materialize()
        run_src = ResolvedSource(NodeStream(g), g, run_src.kind, run_src.origin)
    t0 = time.perf_counter()
    rinfo = None
    shard_info = None
    try:
        if restream_resume is not None:
            # the driver phase finished before the checkpoint was written:
            # its labels and stats ride in the snapshot, skip straight to
            # the restream phase
            env = restream_resume.get("api") or {}
            sd = env.get("driver_stats")
            stats = StreamStats.from_dict(sd) if sd else None
            labels = np.asarray(restream_resume["block"], dtype=np.int64).copy()
        elif ckpt is not None:
            labels, stats = spec.run(run_src, dc, ckpt=ckpt, resume=driver_resume)
        elif dc.workers > 1:
            # sharded multi-worker pass (distributed/shard_driver.py); the
            # restream below then reconciles the shard seams from the exact
            # merged cut + loads the pool hands back
            labels, stats, shard_info = _shard_partition(
                run_src.stream,
                dc.buffcut,
                workers=dc.workers,
                load_sync_every=dc.load_sync_every,
                backend=dc.shard_backend,
                prefetch_batches=dc.pipeline.prefetch_batches,
            )
        else:
            labels, stats = spec.run(run_src, dc)
        if dc.restream_passes > 0:
            # streaming drivers hand over their exact accumulated cut and
            # final block loads (skipping the restream prelude replay); the
            # memory-only baselines don't maintain them, so the prelude
            # computes both
            seeded = stats is not None and spec.streaming
            ckpt_pre = ckpt.written if ckpt is not None else 0
            if ckpt is not None:
                if stats is not None:
                    ckpt.extra["api"]["driver_stats"] = stats.to_dict()
                ckpt.reset()  # restream batch counters restart from zero
            labels, rinfo = _restream_refine(
                run_src.graph if run_src.graph is not None else run_src.stream,
                labels,
                dc.buffcut,
                dc.restream_passes,
                order=dc.restream_order,
                prefetch_batches=dc.pipeline.prefetch_batches,
                initial_cut=stats.cut_weight if seeded else None,
                initial_loads=(
                    np.asarray(stats.block_loads, dtype=np.float64)
                    if seeded and stats.block_loads else None
                ),
                ckpt=ckpt,
                resume=restream_resume,
            )
            if ckpt is not None and stats is not None:
                # restream-phase snapshots land in the same stats counter
                # the driver phase already started
                stats.checkpoints_written += ckpt.written - ckpt_pre
    finally:
        if tmp is not None:
            tmp.cleanup()
    runtime_s = time.perf_counter() - t0
    if stats is not None and rinfo is not None:
        # refresh: the labels were refined, so the streamed quality fields
        # must describe the refined assignment, not pass 1's
        stats.cut_weight = rinfo.cut_weight
        stats.balance = rinfo.balance
        stats.peak_resident_bytes = max(
            stats.peak_resident_bytes, rinfo.peak_resident_bytes
        )
        stats.stream_bytes_read += rinfo.stream_bytes_read
    if perm is not None:  # map stream-position labels back to input node ids
        orig = np.empty_like(labels)
        orig[perm] = labels
        labels = orig
    provenance = {
        "driver": spec.name,
        "engine": dc.buffcut.ml.engine,
        "device": dc.buffcut.ml.device,
        "ordering": dc.ordering,
        "order_seed": dc.order_seed,
        "restream_passes": dc.restream_passes,
        "restream_order": dc.restream_order,
        "source": {
            "kind": src.kind,
            "origin": src.origin,
            "n": int(src.stream.n),
            "m": int(src.stream.m),
        },
        "n_total": float(run_src.stream.n_total),
        "m_total": float(run_src.stream.m_total),
        "runtime_s": runtime_s,
        "config": dc.to_dict(),
    }
    if shard_info is not None:
        # per-worker stats, sync rounds, ranges, pre-reconcile cut split;
        # the post-reconcile trace is provenance["restream"]["passes"]
        provenance["sharded"] = shard_info
    if rinfo is not None:
        # pass-by-pass provenance: replay order, batches, moves, cut trace
        provenance["restream"] = rinfo.to_dict()
    return PartitionResult(
        labels=labels,
        k=dc.buffcut.k,
        stats=stats,
        provenance=provenance,
        graph=src.graph,
    )


def resume(
    checkpoint_path: str,
    source=None,
    config: "DriverConfig | BuffCutConfig | None" = None,
    **overrides,
) -> PartitionResult:
    """Resume a checkpointed `partition` run and carry it to completion.

    Loads the snapshot (magic/version/CRC verified — a torn or corrupt file
    raises `CheckpointError`, never a wrong partition), rebuilds the
    `DriverConfig` recorded in it (flat `overrides` still apply; anything
    that changes the labels fails the resume identity check loudly),
    re-resolves the source — from the recorded path / generator spec, or
    from an explicit `source` when the original was an in-memory object —
    and continues bit-identically from the recorded stream offset.
    Snapshots keep being written to the same file unless overridden with
    ``checkpoint_path=...``.
    """
    state = load_checkpoint(checkpoint_path)
    env = state.get("api") or {}
    if config is not None:
        dc = _coerce_config(config, overrides)
    elif env.get("driver_config_json"):
        dc = DriverConfig.from_json(env["driver_config_json"])
        if overrides:
            dc = DriverConfig.create(dc, **overrides)
    else:
        raise CheckpointError(
            f"checkpoint {checkpoint_path!r} has no recorded config "
            "(written outside repro_torch.api?); pass config= explicitly"
        )
    if dc.checkpoint_path != checkpoint_path and "checkpoint_path" not in overrides:
        dc = dataclasses.replace(dc, checkpoint_path=checkpoint_path)
    if source is None:
        source = env.get("source_spec")
        if source is None:
            raise CheckpointError(
                "the original run's source was an in-memory object the "
                "checkpoint cannot re-resolve; pass source= explicitly"
            )
    return partition(source, dc, _resume_state=state)
