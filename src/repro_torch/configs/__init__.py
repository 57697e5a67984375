"""Architecture registry: `--arch <id>` resolution.

The port holds h2o-danube-1.8b and dlrm-mlperf so far; the reference's
other archs (four LMs, four GNNs) are listed as still to port in
ROADMAP.md.
"""
from repro_torch.configs import dlrm_mlperf, h2o_danube_1_8b
from repro_torch.configs.base import ArchSpec, ShapeDef

ARCHS: dict[str, ArchSpec] = {
    spec.arch_id: spec for spec in [h2o_danube_1_8b.SPEC, dlrm_mlperf.SPEC]
}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def all_cells() -> list[tuple[str, str]]:
    return [c for spec in ARCHS.values() for c in spec.cells()]


__all__ = ["ARCHS", "get_arch", "all_cells", "ArchSpec", "ShapeDef"]
