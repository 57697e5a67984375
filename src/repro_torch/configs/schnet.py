"""schnet [gnn]: 3 interactions, d_hidden=64, 300 RBFs, cutoff 10
[arXiv:1706.08566] (counterpart of `repro/configs/schnet.py`, the same
field values)."""
from repro_torch.configs.base import ArchSpec
from repro_torch.configs.gnn_common import gnn_input_specs, gnn_shapes, gnn_smoke_batch
from repro_torch.models.gnn import SchNetConfig

ARCH_ID = "schnet"


def full_config() -> SchNetConfig:
    return SchNetConfig(name=ARCH_ID, n_interactions=3, d_hidden=64, n_rbf=300, cutoff=10.0)


def smoke_config() -> SchNetConfig:
    return SchNetConfig(
        name=ARCH_ID + "-smoke", n_interactions=2, d_hidden=16, n_rbf=16, cutoff=5.0,
        n_species=8,
    )


SPEC = ArchSpec(
    arch_id=ARCH_ID,
    family="gnn",
    full_config=full_config,
    smoke_config=smoke_config,
    shapes=gnn_shapes(),
    input_specs=lambda cfg, shape: gnn_input_specs("schnet", shape),
    smoke_batch=lambda cfg, seed=0: gnn_smoke_batch("schnet", seed),
    notes="Triplet-gather regime is approximated by RBF cfconv (SchNet's own kernel).",
)
