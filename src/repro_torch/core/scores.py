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
import math

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

    def scalar_fn(self):
        """A pure-Python ``f(a, d, q=0.0, cmax=0.0) -> float`` closure,
        bit-identical to `__call__` on float64 inputs; the pipelined
        driver's per-record loop scores with it instead of paying a numpy
        dispatch per node.

        Python float +, -, *, / are the IEEE-754 operations the float64
        ufunc loops run, and ``maximum(d, 1)`` is ``d if d > 1.0 else 1.0``
        for the finite non-negative degrees the drivers produce.  The one
        treacherous op is ``dn ** beta``: numpy's broadcast power loop
        short-circuits beta 2.0 to ``dn * dn``, 0.5 to ``sqrt`` and -1.0 to
        ``1 / dn``, which are not always bitwise ``pow``, so the closure
        takes the same short-circuits and the np.power ufunc otherwise.
        """
        d_max, beta, theta, eta = self.d_max, self.beta, self.theta, self.eta
        if self.kind == "anr":
            def f(a, d, q=0.0, cmax=0.0):
                return a / (d if d > 1.0 else 1.0)
        elif self.kind == "cbs":
            def f(a, d, q=0.0, cmax=0.0):
                return d / d_max + theta * (a / (d if d > 1.0 else 1.0))
        elif self.kind == "haa" and beta == 2.0:
            def f(a, d, q=0.0, cmax=0.0):
                dn = d / d_max
                return dn * dn + theta * (1.0 - dn) * (a / (d if d > 1.0 else 1.0))
        elif self.kind == "haa":
            if beta == 0.5:
                _pow = math.sqrt
            elif beta == -1.0:
                def _pow(dn):
                    return 1.0 / dn
            else:
                def _pow(dn):
                    return float(np.power(dn, beta))

            def f(a, d, q=0.0, cmax=0.0):
                dn = d / d_max
                return _pow(dn) + theta * (1.0 - dn) * (a / (d if d > 1.0 else 1.0))
        elif self.kind == "nss":
            def f(a, d, q=0.0, cmax=0.0):
                return (a + eta * q) / (d if d > 1.0 else 1.0)
        elif self.kind == "cms":
            def f(a, d, q=0.0, cmax=0.0):
                return cmax / (d if d > 1.0 else 1.0)
        else:
            raise ValueError(self.kind)
        return f


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
