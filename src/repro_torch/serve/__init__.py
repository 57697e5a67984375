"""Partition-as-a-service: keep a partition alive under graph mutation.

`PartitionService` is the resident core (labels + loads + exact
incremental cut + hot-row cache + standing priority buffer), `ServeSession`
the concurrent front door (bounded queue, worker thread, lookup
coalescing), and `workload` the scripted delta-file / churn replay.  Each
refine's V-cycles run on the configured device (the card by default).
"""
from repro_torch.serve.service import (
    DEFAULT_CACHE_BYTES,
    HotAdjacencyCache,
    PartitionService,
)
from repro_torch.serve.session import ServeSession
from repro_torch.serve.workload import (
    ChurnSpec,
    churn_ops,
    load_delta_file,
    run_workload,
)

__all__ = [
    "DEFAULT_CACHE_BYTES",
    "HotAdjacencyCache",
    "PartitionService",
    "ServeSession",
    "ChurnSpec",
    "churn_ops",
    "load_delta_file",
    "run_workload",
]
