"""The BuffCut algorithm library of the port."""
from repro_torch.core.buffcut import BuffCutConfig, StreamStats, buffcut_partition
from repro_torch.core.multilevel import MultilevelConfig, multilevel_partition

__all__ = [
    "BuffCutConfig",
    "StreamStats",
    "buffcut_partition",
    "MultilevelConfig",
    "multilevel_partition",
]
