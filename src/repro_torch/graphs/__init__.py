"""Graph substrate of the port: CSR graphs, generators, stream orderings,
in-memory and disk streams, METIS and packed IO, fault injection, stream
locality (AID), and the GNN fanout sampler."""
from repro_torch.graphs.csr import CSRGraph, bucket_size
from repro_torch.graphs.faults import FaultSchedule, FaultyFile, FaultyOpener
from repro_torch.graphs.generators import (
    generate_to_disk,
    grid_mesh_graph,
    grid_mesh_to_disk,
    rgg_graph,
    rhg_like_graph,
    ring_graph,
    ring_to_disk,
    rmat_graph,
    sbm_graph,
    star_graph,
)
from repro_torch.graphs.io import read_metis, write_metis
from repro_torch.graphs.locality import aid_per_node, geometric_mean, mean_aid
from repro_torch.graphs.orderings import (
    apply_order,
    bfs_order,
    konect_order,
    random_order,
    source_order,
)
from repro_torch.graphs.sampler import cross_block_fraction, sample_block, sample_multihop
from repro_torch.graphs.stream import NodeStream, NodeStreamBase, StreamShard, as_node_stream
from repro_torch.graphs.stream_io import (
    DiskNodeStream,
    StreamFormatError,
    open_stream,
    permute_to_disk,
    read_packed,
    shard_boundary_pass,
    shard_ranges,
    write_packed,
)

__all__ = [
    "CSRGraph",
    "bucket_size",
    "FaultSchedule",
    "FaultyFile",
    "FaultyOpener",
    "generate_to_disk",
    "grid_mesh_graph",
    "grid_mesh_to_disk",
    "rgg_graph",
    "rhg_like_graph",
    "ring_graph",
    "ring_to_disk",
    "rmat_graph",
    "sbm_graph",
    "star_graph",
    "read_metis",
    "write_metis",
    "aid_per_node",
    "geometric_mean",
    "mean_aid",
    "apply_order",
    "bfs_order",
    "konect_order",
    "random_order",
    "source_order",
    "cross_block_fraction",
    "sample_block",
    "sample_multihop",
    "NodeStream",
    "NodeStreamBase",
    "StreamShard",
    "as_node_stream",
    "DiskNodeStream",
    "StreamFormatError",
    "open_stream",
    "permute_to_disk",
    "read_packed",
    "shard_boundary_pass",
    "shard_ranges",
    "write_packed",
]
