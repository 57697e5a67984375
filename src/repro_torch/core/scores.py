"""Buffer scoring functions (paper §3.3): ANR, CBS, HAA, NSS, CMS.

Every score is a closed-form function of small per-node counters the driver
maintains incrementally:
  a  = weight of neighbors already assigned (or admitted to a batch),
  d  = degree (weighted),
  q  = weight of neighbors currently in the buffer      (NSS only),
  cmax = max over blocks of weight of neighbors in that block (CMS only).
All scores are monotone non-decreasing under the driver's update events,
which makes every priority update an IncreaseKey (paper §3.2).

Defaults follow the paper: HAA(beta=2, theta=0.75) is BuffCut's default;
CBS(theta) is Cuttana's score; D_max = 10000.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ScoreSpec:
    """Parameters of a buffer score; `kind` selects the formula."""

    kind: str  # "anr" | "cbs" | "haa" | "nss" | "cms"
    d_max: float = 10000.0
    beta: float = 2.0
    theta: float = 0.75
    eta: float = 0.5

    @property
    def s_max(self) -> float:
        """Upper bound of the score (bucket PQ needs the range)."""
        if self.kind in ("cbs", "haa"):
            return 1.0 + self.theta
        if self.kind in ("anr", "nss", "cms"):
            return 1.0
        raise ValueError(self.kind)

    @property
    def needs_buffered_count(self) -> bool:
        return self.kind == "nss"

    @property
    def needs_block_counts(self) -> bool:
        return self.kind == "cms"

    def __call__(self, a, d, q=0.0, cmax=0.0):
        """Vectorized over numpy arrays as well as python scalars."""
        d_safe = np.maximum(d, 1)
        if self.kind == "anr":
            return a / d_safe
        if self.kind == "cbs":
            return d / self.d_max + self.theta * (a / d_safe)
        if self.kind == "haa":
            dn = d / self.d_max
            return dn**self.beta + self.theta * (1.0 - dn) * (a / d_safe)
        if self.kind == "nss":
            return (a + self.eta * q) / d_safe
        if self.kind == "cms":
            return cmax / d_safe
        raise ValueError(self.kind)


ANR = ScoreSpec("anr")
CBS = ScoreSpec("cbs", theta=0.75)
HAA = ScoreSpec("haa", beta=2.0, theta=0.75)
NSS = ScoreSpec("nss", eta=0.5)
CMS = ScoreSpec("cms")

SCORES = {"anr": ANR, "cbs": CBS, "haa": HAA, "nss": NSS, "cms": CMS}


def get_score(name: str, d_max: float | None = None, **kw) -> ScoreSpec:
    base = SCORES[name.lower()]
    updates = dict(kw)
    if d_max is not None:
        updates["d_max"] = float(d_max)
    return dataclasses.replace(base, **updates) if updates else base
