"""`PartitionResult`: the one return type of `repro_torch.api.partition`.

Carries the labels, the driver's `StreamStats`, provenance (driver, engine,
device, ordering, source, config snapshot) and lazily computed quality
metrics.  Metrics use the exact in-memory computation when the source graph
is resident, and the streaming-measured `StreamStats` fields (`cut_weight`,
`balance`, filled by every BuffCut driver and equal to the offline metrics)
when the partition ran out of core.

`to_json`/`from_json` round-trip everything except the graph handle; the
metrics computed at serialization time are stored, so a deserialized
result still answers quality queries.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

from repro_torch.core import metrics as _metrics
from repro_torch.core.buffcut import StreamStats
from repro_torch.graphs.csr import CSRGraph

RESULT_SCHEMA_VERSION = 1


@dataclasses.dataclass
class PartitionResult:
    labels: np.ndarray                  # node id -> block, int64, input numbering
    k: int
    stats: StreamStats | None
    provenance: dict
    graph: CSRGraph | None = dataclasses.field(default=None, repr=False)
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    # ------------------------------------------------------------ metrics
    @property
    def cut_weight(self) -> float:
        """Total weight of cut edges (exact, in-memory or streaming)."""
        if "cut_weight" not in self._cache:
            if self.graph is not None:
                self._cache["cut_weight"] = _metrics.edge_cut(self.graph, self.labels)
            elif self.stats is not None:
                self._cache["cut_weight"] = float(self.stats.cut_weight)
            else:
                raise ValueError(
                    "cut_weight unavailable: no resident graph and the driver "
                    "returned no StreamStats"
                )
        return self._cache["cut_weight"]

    @property
    def cut_ratio(self) -> float:
        if "cut_ratio" not in self._cache:
            if self.graph is not None:
                self._cache["cut_ratio"] = _metrics.cut_ratio(self.graph, self.labels)
            else:
                m_total = float(self.provenance.get("m_total", 0.0))
                self._cache["cut_ratio"] = (
                    self.cut_weight / m_total if m_total > 0 else 0.0
                )
        return self._cache["cut_ratio"]

    @property
    def balance(self) -> float:
        """max block load / (c(V)/k); 1.0 = perfectly balanced."""
        if "balance" not in self._cache:
            if self.graph is not None:
                self._cache["balance"] = _metrics.balance(self.graph, self.labels, self.k)
            elif self.stats is not None and self.stats.balance > 0:
                self._cache["balance"] = float(self.stats.balance)
            else:
                raise ValueError(
                    "balance unavailable: no resident graph and no streaming "
                    "balance in StreamStats"
                )
        return self._cache["balance"]

    @property
    def ier(self) -> float:
        """Mean internal-edge ratio over batches (needs collect_stats=True;
        0.0 when the driver did not track it)."""
        return self.stats.mean_ier if self.stats is not None else 0.0

    def metrics(self) -> dict:
        return {"cut_ratio": self.cut_ratio, "balance": self.balance, "ier": self.ier}

    # ------------------------------------------------------------- serving
    def into_service(self, source=None, **service_kwargs):
        """Promote this result into a resident `repro_torch.serve.
        PartitionService`: the partition stays alive and accepts
        lookup/update/refine, its refines running the V-cycle on the
        config's `ml.device`.

        Gated on the driver's ``supports_dynamic`` capability (the three
        BuffCut drivers).  The service needs the graph resident: `self.graph`
        when the source was in memory, otherwise it is re-resolved and
        materialized from the provenance origin (file path or ``gen:``
        spec), or from `source` when given.  The service recomputes its
        cut and loads from that graph, so ``service.cut_weight ==
        edge_cut(...)`` holds whatever the ordering or restream history.

        Extra keyword arguments (``buffer_cap``, ``refine_batch``,
        ``cache_bytes``) pass through to `PartitionService`.
        """
        from repro_torch.api.registry import get_partitioner
        from repro_torch.api.sources import resolve_source
        from repro_torch.core.buffcut import BuffCutConfig
        from repro_torch.serve.service import PartitionService

        driver = self.provenance.get("driver")
        if driver is not None:
            spec = get_partitioner(driver)
            if not spec.supports_dynamic:
                raise ValueError(
                    f"driver {spec.name!r} does not support dynamic serving; "
                    "dynamic-capable drivers: buffcut, buffcut-vec, "
                    "buffcut-pipe (see `python -m repro_torch list` capability "
                    "flags)"
                )
        graph = self.graph
        if graph is None:
            origin = source
            if origin is None:
                origin = self.provenance.get("source", {}).get("origin")
            if origin is None:
                raise ValueError(
                    "into_service needs the graph resident: this result has "
                    "no attached graph and its provenance records no "
                    "re-resolvable source; pass source= explicitly"
                )
            graph = resolve_source(origin).materialize()
        cfg_dict = self.provenance.get("config", {}).get("buffcut")
        if cfg_dict is None:
            raise ValueError(
                "into_service needs the BuffCut config snapshot in "
                "provenance['config']['buffcut'] (results from "
                "repro_torch.api.partition always carry it)"
            )
        cfg_dict = dict(cfg_dict)
        cfg_dict.pop("type", None)  # DriverConfig.to_dict discriminator
        cfg = BuffCutConfig.from_dict(cfg_dict)
        return PartitionService(graph, self.labels, cfg, **service_kwargs)

    # ------------------------------------------------------ serialization
    def to_dict(self) -> dict:
        return {
            "version": RESULT_SCHEMA_VERSION,
            "k": int(self.k),
            "labels": self.labels.tolist(),
            "stats": self.stats.to_dict() if self.stats is not None else None,
            "provenance": self.provenance,
            "metrics": self.metrics(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PartitionResult":
        version = d.get("version", RESULT_SCHEMA_VERSION)
        if version != RESULT_SCHEMA_VERSION:
            raise ValueError(
                f"unsupported PartitionResult schema version {version} "
                f"(this build reads version {RESULT_SCHEMA_VERSION})"
            )
        res = cls(
            labels=np.asarray(d["labels"], dtype=np.int64),
            k=int(d["k"]),
            stats=StreamStats.from_dict(d["stats"]) if d.get("stats") else None,
            provenance=d.get("provenance", {}),
        )
        m = d.get("metrics", {})
        res._cache.update(
            {key: float(m[key]) for key in ("cut_ratio", "balance") if key in m}
        )
        return res

    def to_json(self, path: "str | None" = None) -> str:
        text = json.dumps(self.to_dict(), sort_keys=True)
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text

    @classmethod
    def from_json(cls, text_or_path: str) -> "PartitionResult":
        text = text_or_path
        if not text_or_path.lstrip().startswith("{"):
            with open(text_or_path) as f:
                text = f.read()
        return cls.from_dict(json.loads(text))
