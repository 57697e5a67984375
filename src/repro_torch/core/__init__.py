"""The BuffCut algorithm library of the port."""
from repro_torch.core.buffcut import BuffCutConfig, StreamStats, buffcut_partition
from repro_torch.core.multilevel import MultilevelConfig, multilevel_partition
from repro_torch.core.pipeline import PipelineConfig, buffcut_partition_pipelined
from repro_torch.core.vector_stream import (
    VectorizedConfig,
    buffcut_partition_vectorized,
    score_kernel,
)

__all__ = [
    "BuffCutConfig",
    "StreamStats",
    "buffcut_partition",
    "MultilevelConfig",
    "multilevel_partition",
    "PipelineConfig",
    "buffcut_partition_pipelined",
    "VectorizedConfig",
    "buffcut_partition_vectorized",
    "score_kernel",
]
