"""Architecture registry: `--arch <id>` resolution for the reference's
ten archs, in its order."""
from repro_torch.configs import (
    command_r_plus_104b,
    dlrm_mlperf,
    egnn,
    graphsage_reddit,
    h2o_danube_1_8b,
    llama4_scout_17b_a16e,
    meshgraphnet,
    moonshot_v1_16b_a3b,
    schnet,
    stablelm_3b,
)
from repro_torch.configs.base import ArchSpec, ShapeDef

ARCHS: dict[str, ArchSpec] = {
    spec.arch_id: spec
    for spec in [
        llama4_scout_17b_a16e.SPEC,
        moonshot_v1_16b_a3b.SPEC,
        stablelm_3b.SPEC,
        command_r_plus_104b.SPEC,
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
