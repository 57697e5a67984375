"""The partitioner registry: one `PartitionerSpec` per algorithm.

Every algorithm of the port registers here: `register_partitioner` a spec
whose `run(source, config)` maps a `ResolvedSource` + `DriverConfig` to
`(labels, StreamStats | None)`.  `repro_torch.api.partition`, the CLI and
the partition service all dispatch through this table.  Each built-in spec
runs the port's private driver (no preflight, no deprecation warning):
`partition` checks the device once before it calls `run`.

Streaming specs (`streaming=True`) consume the `NodeStreamBase` protocol
and therefore partition straight from disk; memory-only specs hand their
private driver the source's graph, or its stream where there is none, and
the driver's `require_csr` raises the standard actionable `TypeError` on a
disk stream.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.api.config import DriverConfig, as_cuttana
from repro_torch.api.sources import ResolvedSource
from repro_torch.core.buffcut import StreamStats, _buffcut_partition
from repro_torch.core.cuttana import _cuttana_partition
from repro_torch.core.fennel import _fennel_partition, _ldg_partition
from repro_torch.core.heistream import _heistream_partition
from repro_torch.core.pipeline import _buffcut_partition_pipelined
from repro_torch.core.vector_stream import _buffcut_partition_vectorized

RunFn = Callable[[ResolvedSource, DriverConfig], "tuple[np.ndarray, StreamStats | None]"]


@dataclasses.dataclass(frozen=True)
class PartitionerSpec:
    name: str                      # canonical registry key
    run: RunFn
    streaming: bool                # consumes NodeStreamBase (out-of-core OK)
    description: str = ""
    aliases: tuple = ()
    # run accepts ckpt=/resume= kwargs (core/checkpoint.py); the facade
    # refuses checkpoint/resume for specs that don't
    supports_checkpoint: bool = False
    # the facade may route this driver through the sharded multi-worker
    # pool (distributed/shard_driver.py) when DriverConfig.workers > 1
    supports_shard: bool = False
    # results can be promoted to a resident `repro_torch.serve.
    # PartitionService` via `PartitionResult.into_service()`
    supports_dynamic: bool = False

    def capabilities(self) -> dict:
        """Per-algorithm capability flags, the discoverable form of every
        actionable capability error (`python -m repro_torch list`)."""
        return {
            "disk_stream": self.streaming,
            "checkpoint": self.supports_checkpoint,
            "shard": self.supports_shard,
            "dynamic": self.supports_dynamic,
        }


def _in_memory(src: ResolvedSource):
    """The graph a memory-only driver checks: the source's own, else its
    stream (refused by the driver's `require_csr`)."""
    return src.graph if src.graph is not None else src.stream


_REGISTRY: dict[str, PartitionerSpec] = {}
_ALIASES: dict[str, str] = {}


def register_partitioner(spec: PartitionerSpec, *, overwrite: bool = False) -> PartitionerSpec:
    """Add a partitioner to the registry."""
    names = (spec.name, *spec.aliases)
    for name in names:
        taken = name in _REGISTRY or name in _ALIASES
        if taken and not overwrite:
            raise ValueError(
                f"partitioner name {name!r} is already registered; pass "
                "overwrite=True to replace it"
            )
    if overwrite:  # reclaim every name, whether it was canonical or an alias
        for name in names:
            _REGISTRY.pop(name, None)
            _ALIASES.pop(name, None)
    _REGISTRY[spec.name] = spec
    for alias in spec.aliases:
        _ALIASES[alias] = spec.name
    return spec


def get_partitioner(name: str) -> PartitionerSpec:
    key = _ALIASES.get(name, name)
    spec = _REGISTRY.get(key)
    if spec is None:
        raise KeyError(
            f"unknown partitioner {name!r}: registered names are "
            f"{list_partitioners()} (aliases: {sorted(_ALIASES)})"
        )
    return spec


def list_partitioners() -> list[str]:
    """Canonical registry names, registration order."""
    return list(_REGISTRY)


# --------------------------------------------------------------------------
# built-in registrations: the paper's drivers and the baselines it compares to
# --------------------------------------------------------------------------


register_partitioner(PartitionerSpec(
    name="buffcut",
    aliases=("sequential",),
    streaming=True,
    description="BuffCut sequential driver (paper Alg. 1): prioritized "
                "buffer + batch-wise multilevel.",
    supports_checkpoint=True,
    supports_shard=True,
    supports_dynamic=True,
    run=lambda src, dc, **kw: _buffcut_partition(
        src.stream, dc.buffcut,
        prefetch_batches=dc.pipeline.prefetch_batches, **kw,
    ),
))

register_partitioner(PartitionerSpec(
    name="buffcut-vec",
    aliases=("vectorized",),
    streaming=True,
    description="Vectorized BuffCut: dense score vectors + top-wave "
                "eviction (wave=1,chunk=1 is bit-exact).",
    supports_checkpoint=True,
    supports_dynamic=True,
    run=lambda src, dc, **kw: _buffcut_partition_vectorized(
        src.stream, dc.buffcut, dc.vectorized,
        prefetch_batches=dc.pipeline.prefetch_batches, **kw,
    ),
))

register_partitioner(PartitionerSpec(
    name="buffcut-pipe",
    aliases=("pipelined", "buffcut-par"),
    streaming=True,
    description="Pipelined BuffCut (paper §3.5): reader / PQ handler / "
                "partition worker threads.",
    supports_checkpoint=True,
    supports_dynamic=True,
    run=lambda src, dc, **kw: _buffcut_partition_pipelined(
        src.stream, dc.buffcut, dc.pipeline, **kw
    ),
))

register_partitioner(PartitionerSpec(
    name="heistream",
    streaming=False,
    description="HeiStream baseline [Faraj & Schulz]: contiguous batches, "
                "same multilevel scheme (memory-only).",
    run=lambda src, dc: _heistream_partition(_in_memory(src), dc.buffcut),
))

register_partitioner(PartitionerSpec(
    name="cuttana",
    streaming=False,
    description="Cuttana baseline [Hajidehi et al.]: CBS buffer + "
                "sequential Fennel eviction + sub-partition trades "
                "(memory-only).",
    run=lambda src, dc: _cuttana_partition(
        _in_memory(src), as_cuttana(dc.buffcut)
    ),
))

register_partitioner(PartitionerSpec(
    name="fennel",
    streaming=False,
    description="Fennel one-pass baseline [Tsourakakis et al.] (memory-only).",
    run=lambda src, dc: (
        _fennel_partition(
            _in_memory(src),
            dc.buffcut.k, dc.buffcut.eps, dc.buffcut.gamma,
        ),
        None,
    ),
))

register_partitioner(PartitionerSpec(
    name="ldg",
    streaming=False,
    description="Linear Deterministic Greedy baseline [Stanton & Kliot] "
                "(memory-only).",
    run=lambda src, dc: (
        _ldg_partition(_in_memory(src), dc.buffcut.k, dc.buffcut.eps),
        None,
    ),
))
