"""`DriverConfig`: the one config object `repro_torch.api.partition`
consumes.

Composes the existing config dataclasses: `BuffCutConfig` (algorithm
parameters, including the nested `MultilevelConfig`), `VectorizedConfig`
(the vectorized driver's knobs) and `PipelineConfig` (the pipelined
driver's), plus the facade-level knobs: which driver, which stream
ordering, the restreaming post-pass count and replay order, checkpointing
and sharding.

`DriverConfig.create` is the flat-kwarg builder the CLI and the
`partition(source, k=..., driver=...)` path share: every key is routed to
the dataclass that owns it (``engine`` and ``device`` to the multilevel
config), and unknown keys fail loudly with the full routing table.
"""
from __future__ import annotations

import dataclasses
import json

from repro_torch.core.buffcut import BuffCutConfig
from repro_torch.core.cuttana import CuttanaConfig
from repro_torch.core.multilevel import MultilevelConfig
from repro_torch.core.pipeline import PipelineConfig
from repro_torch.core.restream import RESTREAM_ORDERS
from repro_torch.core.vector_stream import VectorizedConfig
from repro_torch.distributed.shard_driver import SHARD_BACKENDS

ORDERINGS = ("natural", "random", "bfs", "konect")

# flat-kwarg routing table for DriverConfig.create (CLI + partition(**kw))
_TOP_KEYS = (
    "driver", "ordering", "order_seed", "restream_passes", "restream_order",
    "checkpoint_path", "checkpoint_every",
    "workers", "load_sync_every", "shard_backend",
)
_BUFFCUT_KEYS = (
    "k", "eps", "buffer_size", "batch_size", "d_max", "score",
    "disc_factor", "gamma", "collect_stats",
)
_ML_KEYS = (
    "coarsen_target", "max_levels", "lp_iters", "refine_rounds",
    "min_shrink", "seed", "agg_autotune", "engine", "device",
)
_VEC_KEYS = ("wave", "chunk")  # plus "vec_engine" -> VectorizedConfig.engine
_PIPE_KEYS = ("queue_depth", "prefetch_batches")
_CUTTANA_KEYS = ("subpart_ratio", "refine_passes")


def _default_buffcut() -> BuffCutConfig:
    return BuffCutConfig(k=16)


def as_cuttana(cfg: BuffCutConfig) -> CuttanaConfig:
    """Upgrade a BuffCutConfig to a CuttanaConfig (default phase-2 knobs),
    passing an existing CuttanaConfig through untouched."""
    if isinstance(cfg, CuttanaConfig):
        return cfg
    return CuttanaConfig(
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(BuffCutConfig)}
    )


@dataclasses.dataclass
class DriverConfig:
    driver: str = "buffcut"
    buffcut: BuffCutConfig = dataclasses.field(default_factory=_default_buffcut)
    vectorized: VectorizedConfig = dataclasses.field(default_factory=VectorizedConfig)
    pipeline: PipelineConfig = dataclasses.field(default_factory=PipelineConfig)
    restream_passes: int = 0
    restream_order: str = "stream"
    ordering: str = "natural"
    order_seed: int = 0
    # crash-safe checkpointing (core/checkpoint.py): snapshot to
    # `checkpoint_path` every `checkpoint_every` committed batches
    checkpoint_path: "str | None" = None
    checkpoint_every: int = 0
    # sharded multi-worker partitioning (distributed/shard_driver.py): W
    # contiguous id-range shards, one driver each, loads synced every
    # `load_sync_every` committed batches per worker
    workers: int = 1
    load_sync_every: int = 8
    shard_backend: str = "thread"

    def __post_init__(self) -> None:
        if self.ordering not in ORDERINGS:
            raise ValueError(
                f"unknown ordering {self.ordering!r}: pick one of {ORDERINGS}"
            )
        if self.restream_passes < 0:
            raise ValueError(
                f"restream_passes must be >= 0, got {self.restream_passes}"
            )
        if self.restream_order not in RESTREAM_ORDERS:
            raise ValueError(
                f"unknown restream_order {self.restream_order!r}: pick one of "
                f"{RESTREAM_ORDERS}"
            )
        if self.checkpoint_every < 0:
            raise ValueError(
                f"checkpoint_every must be >= 0, got {self.checkpoint_every}"
            )
        if self.checkpoint_every > 0 and not self.checkpoint_path:
            raise ValueError(
                "checkpoint_every > 0 needs a checkpoint_path to write to"
            )
        if self.checkpoint_path and self.checkpoint_every == 0:
            self.checkpoint_every = 8  # a path alone opts in at the default cadence
        if self.workers < 1:
            raise ValueError(f"workers must be >= 1, got {self.workers}")
        if self.load_sync_every < 1:
            raise ValueError(
                f"load_sync_every must be >= 1, got {self.load_sync_every}"
            )
        if self.shard_backend not in SHARD_BACKENDS:
            raise ValueError(
                f"unknown shard_backend {self.shard_backend!r}: pick one of "
                f"{SHARD_BACKENDS}"
            )
        if self.workers > 1 and self.checkpoint_path:
            # a sharded run has W stream positions plus barrier state: one
            # resume token cannot represent it
            raise ValueError(
                "checkpointing is not supported with workers > 1: a sharded "
                "run has one stream position per worker and cannot resume "
                "from a single token; drop checkpoint_path or run workers=1"
            )

    # ------------------------------------------------------- flat builder
    @classmethod
    def create(cls, base: "DriverConfig | None" = None, **kw) -> "DriverConfig":
        """Build (or override) a DriverConfig from flat kwargs.

        ``engine`` and ``device`` route to the multilevel config
        (``ml.engine``, ``ml.device``); ``vec_engine`` to the vectorized
        buffer engine.  Cuttana's ``subpart_ratio``/``refine_passes``
        upgrade the algorithm config to a `CuttanaConfig`.
        """
        top: dict = {}
        bc: dict = {}
        ml: dict = {}
        vec: dict = {}
        pipe: dict = {}
        cut: dict = {}
        for key, val in kw.items():
            if key in _TOP_KEYS:
                top[key] = val
            elif key in _BUFFCUT_KEYS:
                bc[key] = val
            elif key in _ML_KEYS:
                ml[key] = val
            elif key in _VEC_KEYS:
                vec[key] = val
            elif key == "vec_engine":
                vec["engine"] = val
            elif key in _PIPE_KEYS:
                pipe[key] = val
            elif key in _CUTTANA_KEYS:
                cut[key] = val
            else:
                raise TypeError(
                    f"unknown partition option {key!r}; valid options: "
                    f"{_TOP_KEYS + _BUFFCUT_KEYS + _ML_KEYS} "
                    f"(multilevel), {_VEC_KEYS + ('vec_engine',)} (vectorized), "
                    f"{_PIPE_KEYS} (pipelined), {_CUTTANA_KEYS} (cuttana)"
                )
        base = base if base is not None else cls()
        buffcut = base.buffcut
        if ml:
            bc["ml"] = dataclasses.replace(buffcut.ml, **ml)
        if bool(cut) or top.get("driver", base.driver) == "cuttana":
            buffcut = as_cuttana(buffcut)
        if bc or cut:
            buffcut = dataclasses.replace(buffcut, **bc, **cut)
        return dataclasses.replace(
            base,
            buffcut=buffcut,
            vectorized=dataclasses.replace(base.vectorized, **vec),
            pipeline=dataclasses.replace(base.pipeline, **pipe),
            **top,
        )

    # ------------------------------------------------------ serialization
    def to_dict(self) -> dict:
        bc = self.buffcut.to_dict()
        bc["type"] = "cuttana" if isinstance(self.buffcut, CuttanaConfig) else "buffcut"
        return {
            "driver": self.driver,
            "buffcut": bc,
            "vectorized": self.vectorized.to_dict(),
            "pipeline": self.pipeline.to_dict(),
            "restream_passes": self.restream_passes,
            "restream_order": self.restream_order,
            "ordering": self.ordering,
            "order_seed": self.order_seed,
            "checkpoint_path": self.checkpoint_path,
            "checkpoint_every": self.checkpoint_every,
            "workers": self.workers,
            "load_sync_every": self.load_sync_every,
            "shard_backend": self.shard_backend,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "DriverConfig":
        """Reads the port's configs and the reference's (whose `ml` has no
        `device`: it takes the default, "cuda")."""
        bc = dict(d["buffcut"])
        bc_cls = CuttanaConfig if bc.pop("type", "buffcut") == "cuttana" else BuffCutConfig
        return cls(
            driver=d.get("driver", "buffcut"),
            buffcut=bc_cls.from_dict(bc),
            vectorized=VectorizedConfig.from_dict(d.get("vectorized", {})),
            pipeline=PipelineConfig.from_dict(d.get("pipeline", {})),
            restream_passes=d.get("restream_passes", 0),
            restream_order=d.get("restream_order", "stream"),
            ordering=d.get("ordering", "natural"),
            order_seed=d.get("order_seed", 0),
            checkpoint_path=d.get("checkpoint_path"),
            checkpoint_every=d.get("checkpoint_every", 0),
            workers=d.get("workers", 1),
            load_sync_every=d.get("load_sync_every", 8),
            shard_backend=d.get("shard_backend", "thread"),
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "DriverConfig":
        return cls.from_dict(json.loads(s))


__all__ = [
    "DriverConfig",
    "as_cuttana",
    "BuffCutConfig",
    "CuttanaConfig",
    "MultilevelConfig",
    "VectorizedConfig",
    "PipelineConfig",
    "ORDERINGS",
]
