"""meshgraphnet [gnn]: 15 layers, d_hidden=128, sum aggregator, 2-layer
MLPs [arXiv:2010.03409] (counterpart of `repro/configs/meshgraphnet.py`,
the same field values)."""
from repro_torch.configs.base import ArchSpec
from repro_torch.configs.gnn_common import gnn_input_specs, gnn_shapes, gnn_smoke_batch
from repro_torch.models.gnn import MeshGraphNetConfig

ARCH_ID = "meshgraphnet"


def full_config() -> MeshGraphNetConfig:
    return MeshGraphNetConfig(name=ARCH_ID, n_layers=15, d_hidden=128, mlp_layers=2)


def smoke_config() -> MeshGraphNetConfig:
    return MeshGraphNetConfig(
        name=ARCH_ID + "-smoke", n_layers=3, d_hidden=32, mlp_layers=2, d_node_in=8
    )


SPEC = ArchSpec(
    arch_id=ARCH_ID,
    family="gnn",
    full_config=full_config,
    smoke_config=smoke_config,
    shapes=gnn_shapes(),
    input_specs=lambda cfg, shape: gnn_input_specs("meshgraphnet", shape),
    smoke_batch=lambda cfg, seed=0: gnn_smoke_batch("meshgraphnet", seed, f=cfg.d_node_in),
)
