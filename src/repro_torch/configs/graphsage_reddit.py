"""graphsage-reddit [gnn]: 2 layers, d_hidden=128, mean aggregator, sample
sizes 25-10 [arXiv:1706.02216] (counterpart of
`repro/configs/graphsage_reddit.py`, the same field values)."""
from repro_torch.configs.base import ArchSpec
from repro_torch.configs.gnn_common import gnn_input_specs, gnn_shapes, gnn_smoke_batch
from repro_torch.models.gnn import GraphSAGEConfig

ARCH_ID = "graphsage-reddit"


def full_config() -> GraphSAGEConfig:
    return GraphSAGEConfig(
        name=ARCH_ID, n_layers=2, d_hidden=128, d_in=602, n_classes=41,
        sample_sizes=(25, 10),
    )


def smoke_config() -> GraphSAGEConfig:
    return GraphSAGEConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_hidden=16, d_in=8, n_classes=5,
        sample_sizes=(4, 3),
    )


SPEC = ArchSpec(
    arch_id=ARCH_ID,
    family="gnn",
    full_config=full_config,
    smoke_config=smoke_config,
    shapes=gnn_shapes(),
    input_specs=lambda cfg, shape: gnn_input_specs("graphsage", shape),
    smoke_batch=lambda cfg, seed=0: gnn_smoke_batch("graphsage", seed, f=cfg.d_in),
    notes="minibatch_lg uses the real fanout sampler (graphs/sampler.py).",
)
