"""The benchmark's frozen yardstick: the card's published peaks and the work
that a kernel launch needs, counted from its shapes.  These counts stay
as they are when a later change redesigns a kernel; a redesign shows as
a change of time against the same count.
"""
from __future__ import annotations

import subprocess

# one NVIDIA H100 SXM, NVIDIA's data sheet (dense, at the full 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi prints them ("not
    read" where it cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"


def hist_bytes(b: int, w: int, k: int) -> int:
    """`ell_histogram` on (B, W) int32 labels and float32 weights into (B, k)
    float32 counts: each input entry read once (8 bytes), each count
    written once (4 bytes)."""
    return 8 * b * w + 4 * b * k


def sweep_steps(n_free: int) -> int:
    """`fennel_sweep`: one dependent step per free node of the coarsest
    level."""
    return int(n_free)


def bound_s(bytes_moved: float, ops: float = 0.0, ops_per_s: float = FP32_OPS_PER_S) -> float:
    """The least time the card can take: bytes at its memory rate or
    operations at `ops_per_s`, whichever is longer."""
    return max(bytes_moved / HBM_BYTES_PER_S, ops / ops_per_s)
