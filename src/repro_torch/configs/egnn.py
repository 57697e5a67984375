"""egnn [gnn]: 4 layers, d_hidden=64, E(n)-equivariant [arXiv:2102.09844]
(counterpart of `repro/configs/egnn.py`, the same field values)."""
from repro_torch.configs.base import ArchSpec
from repro_torch.configs.gnn_common import gnn_input_specs, gnn_shapes, gnn_smoke_batch
from repro_torch.models.gnn import EGNNConfig

ARCH_ID = "egnn"


def full_config() -> EGNNConfig:
    return EGNNConfig(name=ARCH_ID, n_layers=4, d_hidden=64)


def smoke_config() -> EGNNConfig:
    return EGNNConfig(name=ARCH_ID + "-smoke", n_layers=2, d_hidden=16, d_in=8)


SPEC = ArchSpec(
    arch_id=ARCH_ID,
    family="gnn",
    full_config=full_config,
    smoke_config=smoke_config,
    shapes=gnn_shapes(),
    input_specs=lambda cfg, shape: gnn_input_specs("egnn", shape),
    smoke_batch=lambda cfg, seed=0: gnn_smoke_batch("egnn", seed, f=cfg.d_in),
    notes="d_in adapts to each shape's feature width at lowering time.",
)
