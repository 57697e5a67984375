"""Arch/shape registry protocol (counterpart of `repro/configs/base.py`).

Every architecture module registers an ArchSpec carrying:
  - full_config(): the exact published configuration,
  - smoke_config(): a reduced same-family configuration for CPU tests,
  - shapes: the arch's assigned input-shape set,
  - input_specs(config, shape): `(shape, torch.dtype)` for every step input
    (the reference returns `jax.ShapeDtypeStruct`s),
  - smoke_batch(config, seed): real (small) tensors for the smoke test.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable


@dataclasses.dataclass(frozen=True)
class ShapeDef:
    name: str
    kind: str                      # train | prefill | decode | retrieval | serve
    dims: dict
    skip: str | None = None        # reason if this cell is inapplicable


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                    # lm | gnn | recsys
    full_config: Callable[[], object]
    smoke_config: Callable[[], object]
    shapes: dict[str, ShapeDef]
    input_specs: Callable[[object, ShapeDef], dict]  # -> {name: (shape, dtype)}
    smoke_batch: Callable[[object, int], dict]       # (config, seed) -> tensors
    notes: str = ""

    def cells(self):
        return [(self.arch_id, s) for s in self.shapes]
