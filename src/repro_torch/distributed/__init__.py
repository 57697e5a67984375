"""Distributed runtime of the port: shard-parallel partitioning.

Names resolve lazily (PEP 562), so importing the package loads nothing
until a name is used.
"""

_LAZY = {
    "ShardPool": "shard_driver",
    "SharedLoads": "shard_driver",
    "ShardWorkerError": "shard_driver",
    "shard_partition": "shard_driver",
    "SHARD_BACKENDS": "shard_driver",
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
