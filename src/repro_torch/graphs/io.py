"""METIS-format graph IO (the paper's input format); the text written is
byte-identical to the reference package's.

METIS format: first line `n m [fmt]`; line i+1 lists the (1-indexed)
neighbors of node i; fmt=1 (01) adds edge weights, fmt=10 node weights,
fmt=11 both.  The paper converts all instances to METIS format with unit
weights.

Parsing is delegated to the chunked streaming parser in
graphs/stream_io.py — `read_metis` is the materializing convenience on top
of the same code path the out-of-core `DiskNodeStream` uses, so whole-file
and chunked parses cannot diverge.  Malformed files (bad header, truncated
data, out-of-range neighbors, m mismatch) raise `StreamFormatError`.
"""
from __future__ import annotations

import os

import numpy as np

from repro_torch.graphs.csr import CSRGraph
from repro_torch.graphs.stream_io import (  # noqa: F401 (StreamFormatError re-export)
    MetisChunkReader,
    StreamFormatError,
    materialize_records,
)


def _fmt_weight(w: float) -> str:
    """Weights round-trip exactly: integers as ints, else shortest repr of
    the float32 value (the seed writer truncated 2.5 -> 2)."""
    w = float(w)
    return str(int(w)) if w.is_integer() else repr(w)


def write_metis(g: CSRGraph, path: str) -> None:
    has_ew = not np.all(g.edge_w == 1.0)
    has_nw = not np.all(g.node_w == 1.0)
    fmt = f"{int(has_nw)}{int(has_ew)}"
    # tmp + fsync + replace: a crash mid-write must not leave a
    # torn graph file under the final name
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        header = f"{g.n} {g.m}"
        if fmt != "00":
            header += f" {fmt}"
        f.write(header + "\n")
        for v in range(g.n):
            parts: list[str] = []
            if has_nw:
                parts.append(_fmt_weight(g.node_w[v]))
            nbrs = g.neighbors(v)
            wts = g.neighbor_weights(v)
            for u, w in zip(nbrs, wts):
                parts.append(str(int(u) + 1))
                if has_ew:
                    parts.append(_fmt_weight(w))
            f.write(" ".join(parts) + "\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_metis(path: str) -> CSRGraph:
    """Materialize a METIS file as a CSRGraph via the chunked parser."""
    reader = MetisChunkReader(path)
    n, _, _, _ = reader.header()
    return materialize_records(n, reader.records())
