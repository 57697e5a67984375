"""Graph substrate of the port: CSR graphs, generators, stream orderings,
in-memory stream."""
from repro_torch.graphs.csr import CSRGraph, bucket_size
from repro_torch.graphs.generators import grid_mesh_graph, rmat_graph, sbm_graph
from repro_torch.graphs.orderings import (
    apply_order,
    bfs_order,
    konect_order,
    random_order,
    source_order,
)
from repro_torch.graphs.stream import NodeStream, NodeStreamBase, as_node_stream

__all__ = [
    "CSRGraph",
    "bucket_size",
    "grid_mesh_graph",
    "rmat_graph",
    "sbm_graph",
    "apply_order",
    "bfs_order",
    "konect_order",
    "random_order",
    "source_order",
    "NodeStream",
    "NodeStreamBase",
    "as_node_stream",
]
