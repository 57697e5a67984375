"""Architecture registry: `--arch <id>` resolution.

The port holds h2o-danube-1.8b, dlrm-mlperf and the four GNNs (egnn,
meshgraphnet, schnet, graphsage-reddit); the reference's four other LMs
are listed as still to port in ROADMAP.md.
"""
from repro_torch.configs import (
    dlrm_mlperf,
    egnn,
    graphsage_reddit,
    h2o_danube_1_8b,
    meshgraphnet,
    schnet,
)
from repro_torch.configs.base import ArchSpec, ShapeDef

ARCHS: dict[str, ArchSpec] = {
    spec.arch_id: spec
    for spec in [
        h2o_danube_1_8b.SPEC,
        egnn.SPEC,
        meshgraphnet.SPEC,
        schnet.SPEC,
        graphsage_reddit.SPEC,
        dlrm_mlperf.SPEC,
    ]
}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def all_cells() -> list[tuple[str, str]]:
    return [c for spec in ARCHS.values() for c in spec.cells()]


__all__ = ["ARCHS", "get_arch", "all_cells", "ArchSpec", "ShapeDef"]
