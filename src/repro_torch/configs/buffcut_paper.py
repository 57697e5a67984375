"""The paper's own configuration surface (BuffCut streaming partitioner).

Defaults follow §4 Setup: discFactor=1000, D_max=10000, HAA(beta=2,
theta=0.75), eps=3%, k=32 for tuning, Q_max=262144 / delta=32768 for the
score study, Q_max=1048576 / delta=65536 for the test-set comparison.
`scaled_config` shrinks the graph-dependent sizes proportionally.  The
multilevel config is the port's default (engine "auto" on "cuda").
"""
from __future__ import annotations

from repro_torch.core.buffcut import BuffCutConfig
from repro_torch.core.multilevel import MultilevelConfig


def paper_config(k: int = 32) -> BuffCutConfig:
    """Exact paper parameters (for full-scale graphs)."""
    return BuffCutConfig(
        k=k, eps=0.03, buffer_size=262144, batch_size=32768,
        d_max=10000.0, score="haa", disc_factor=1000,
        ml=MultilevelConfig(),
    )


def testset_config(k: int = 32) -> BuffCutConfig:
    """Test-set comparison parameters (paper §4.3)."""
    return BuffCutConfig(
        k=k, eps=0.03, buffer_size=1048576, batch_size=65536,
        d_max=10000.0, score="haa", disc_factor=1000,
        ml=MultilevelConfig(),
    )


def scaled_config(n_nodes: int, k: int = 32, *, eps: float = 0.03) -> BuffCutConfig:
    """Smaller-graph preset: buffer ~ n/8, batch ~ n/32 (the ratios the
    paper's sweet spot uses relative to its instances)."""
    buf = max(min(262144, n_nodes // 8), 16)
    delta = max(min(32768, n_nodes // 32), 8)
    d_max = min(10000.0, max(64.0, n_nodes / 16))
    return BuffCutConfig(
        k=k, eps=eps, buffer_size=buf, batch_size=delta, d_max=d_max,
        score="haa", disc_factor=1000, ml=MultilevelConfig(),
    )
