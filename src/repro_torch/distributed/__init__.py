"""Distributed runtime of the port: shard-parallel partitioning, GNN
placement, gradient compression, and the model-parallel runtime on a
device mesh (sharding rules, the ring collective matmul; `spmd` holds the
local regions the models run in).

Names resolve lazily (PEP 562), so importing the package loads nothing
until a name is used.
"""

_LAZY = {
    "ShardPool": "shard_driver",
    "SharedLoads": "shard_driver",
    "ShardWorkerError": "shard_driver",
    "shard_partition": "shard_driver",
    "SHARD_BACKENDS": "shard_driver",
    # BuffCut as the placement service of GNN training
    "Placement": "gnn_placement",
    "place_graph": "gnn_placement",
    "placement_report": "gnn_placement",
    "reorder_for_shards": "gnn_placement",
    # gradient compression
    "topk_compress": "compression",
    "topk_decompress": "compression",
    "error_feedback_update": "compression",
    "compress_grads_with_feedback": "compression",
    "init_residuals": "compression",
    "quantize_int8": "compression",
    "dequantize_int8": "compression",
    "quantized_psum": "compression",
    # model-parallel runtime (torch.distributed)
    "ShardingRules": "sharding",
    "MeshSharding": "sharding",
    "lm_sharding_rules": "sharding",
    "lm_decode_sharding_rules": "sharding",
    "gnn_sharding_rules": "sharding",
    "dlrm_sharding_rules": "sharding",
    "param_shardings": "sharding",
    "batch_shardings": "sharding",
    "collective_matmul_allgather": "overlap",
    "halo_batch": "gnn_placement",
}

__all__ = list(_LAZY)


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
