"""The BuffCut algorithm library of the port."""
from repro_torch.core.buffcut import BuffCutConfig, StreamStats, buffcut_partition
from repro_torch.core.cuttana import CuttanaConfig, cuttana_partition
from repro_torch.core.fennel import FennelParams, fennel_choose, fennel_partition, ldg_partition
from repro_torch.core.heistream import heistream_partition
from repro_torch.core.histogram import (
    best_label_per_src,
    label_histogram_ell,
    neighbor_label_weights,
    sorted_neighbor_label_weights,
)
from repro_torch.core.checkpoint import (
    CheckpointError,
    Checkpointer,
    load_checkpoint,
    save_checkpoint,
)
from repro_torch.core.metrics import (
    IncrementalCut,
    balance,
    block_loads,
    cut_ratio,
    edge_cut,
    internal_edge_ratio,
    internal_edge_ratio_adj,
    l_max,
    streaming_cut_increment,
)
from repro_torch.core.multilevel import MultilevelConfig, multilevel_partition
from repro_torch.core.pipeline import PipelineConfig, buffcut_partition_pipelined
from repro_torch.core.restream import (
    RESTREAM_ORDERS,
    MicroRestreamer,
    RestreamInfo,
    restream,
    restream_pass,
    restream_refine,
)
from repro_torch.core.vector_stream import (
    VectorizedConfig,
    buffcut_partition_vectorized,
    score_kernel,
)

__all__ = [
    "BuffCutConfig",
    "StreamStats",
    "buffcut_partition",
    "CheckpointError",
    "Checkpointer",
    "load_checkpoint",
    "save_checkpoint",
    "CuttanaConfig",
    "cuttana_partition",
    "FennelParams",
    "fennel_choose",
    "fennel_partition",
    "ldg_partition",
    "heistream_partition",
    "best_label_per_src",
    "label_histogram_ell",
    "neighbor_label_weights",
    "sorted_neighbor_label_weights",
    "IncrementalCut",
    "balance",
    "block_loads",
    "cut_ratio",
    "edge_cut",
    "internal_edge_ratio",
    "internal_edge_ratio_adj",
    "l_max",
    "streaming_cut_increment",
    "MultilevelConfig",
    "multilevel_partition",
    "PipelineConfig",
    "buffcut_partition_pipelined",
    "RESTREAM_ORDERS",
    "MicroRestreamer",
    "RestreamInfo",
    "restream",
    "restream_pass",
    "restream_refine",
    "VectorizedConfig",
    "buffcut_partition_vectorized",
    "score_kernel",
]
