"""The legacy-entry-point policy of the port.

The partitioner functions stay importable from `repro_torch.core`, but each
is a thin shim over a private implementation: it emits a
`DeprecationWarning` naming the one front door (`repro_torch.api.partition`)
and delegates.  The API calls the private implementations directly, so the
warning fires exactly when user code takes the legacy path; the two paths
give bit-identical labels (pinned in tests/test_torch_api.py).
"""
from __future__ import annotations

import warnings

from repro_torch.graphs.csr import CSRGraph

_STREAMING_DRIVERS = "buffcut / buffcut-vec / buffcut-pipe"


def warn_legacy(old: str, new: str) -> None:
    """Emit the standard legacy-entry-point DeprecationWarning."""
    warnings.warn(
        f"{old} is deprecated; call repro_torch.api.partition instead, e.g. {new}",
        DeprecationWarning,
        stacklevel=3,
    )


def require_csr(g: object, algo: str) -> CSRGraph:
    """Memory-only algorithms fail fast on streams, not deep in CSR access."""
    if isinstance(g, CSRGraph):
        return g
    raise TypeError(
        f"{algo} is memory-only and needs a CSRGraph, got {type(g).__name__}. "
        "Materialize the stream first (repro_torch.graphs.read_packed/read_metis, "
        "repro_torch.api.resolve_source(...).materialize(), or the CLI's "
        f"--materialize flag) or use a streaming driver ({_STREAMING_DRIVERS})."
    )
