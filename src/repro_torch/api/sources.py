"""Source resolution: every way a graph can reach the partitioner.

`resolve_source` accepts the five source kinds of the API and normalizes
them into a `ResolvedSource` that always carries a `NodeStreamBase` (what
the streaming drivers consume) and, when the graph lives in memory, the
`CSRGraph` (what the memory-only baselines and the restream post-pass
need):

  * `CSRGraph`                  kind "graph"
  * `NodeStreamBase`            kind "stream" (an in-memory `NodeStream`
                                exposes its wrapped graph; a disk stream
                                does not)
  * path to METIS text          kind "metis",  streamed via DiskNodeStream
  * path to packed binary       kind "packed", streamed via DiskNodeStream
  * generator spec string       kind "generated", e.g. "gen:grid:side=64"
                                or "gen:rmat:n=4096,avg_degree=8,seed=11"
                                (families: {families})

Memory-only algorithms never silently materialize a disk stream: they are
handed the stream where there is no graph, and their own `require_csr`
raises the actionable `TypeError`.  `materialize()`
is the explicit opt-in that loads a disk source (or assembles any stream)
into a CSRGraph.
"""
from __future__ import annotations

import dataclasses
import os

from repro_torch.graphs.csr import CSRGraph
from repro_torch.graphs.generators import (
    grid_mesh_graph,
    rgg_graph,
    rhg_like_graph,
    ring_graph,
    rmat_graph,
    sbm_graph,
    star_graph,
)
from repro_torch.graphs.io import read_metis
from repro_torch.graphs.stream import NodeStream, NodeStreamBase
from repro_torch.graphs.stream_io import MAGIC, DiskNodeStream, materialize_records, read_packed

GEN_PREFIX = "gen:"

GENERATORS = {
    "rmat": rmat_graph,
    "rgg": rgg_graph,
    "rhg": rhg_like_graph,
    "grid": grid_mesh_graph,
    "sbm": sbm_graph,
    "star": star_graph,
    "ring": ring_graph,
}

if __doc__:  # stripped under -OO
    __doc__ = __doc__.format(families=", ".join(sorted(GENERATORS)))


def _parse_value(tok: str):
    for cast in (int, float):
        try:
            return cast(tok)
        except ValueError:
            pass
    if tok.lower() in ("true", "false"):
        return tok.lower() == "true"
    return tok


def parse_generator_spec(spec: str) -> tuple[str, dict]:
    """``gen:<family>[:k=v[,k=v...]]`` -> (family, params)."""
    body = spec[len(GEN_PREFIX):]
    family, _, params_s = body.partition(":")
    if family not in GENERATORS:
        raise ValueError(
            f"unknown generator family {family!r} in source spec {spec!r}: "
            f"known families are {sorted(GENERATORS)}"
        )
    params: dict = {}
    for item in filter(None, params_s.split(",")):
        key, sep, val = item.partition("=")
        if not sep:
            raise ValueError(
                f"malformed generator param {item!r} in {spec!r} (want key=value)"
            )
        params[key] = _parse_value(val)
    return family, params


def build_generated(spec: str) -> CSRGraph:
    family, params = parse_generator_spec(spec)
    try:
        return GENERATORS[family](**params)
    except TypeError as e:
        raise ValueError(f"bad params for generator {family!r}: {e}") from None


@dataclasses.dataclass
class ResolvedSource:
    stream: NodeStreamBase
    graph: CSRGraph | None
    kind: str            # "graph" | "stream" | "metis" | "packed" | "generated"
    origin: str          # provenance string (path / spec / shape)
    path: str | None = None

    def materialize(self) -> CSRGraph:
        """Explicitly load this source into memory (opt-in: defeats the
        out-of-core property for disk sources)."""
        if self.graph is None:
            if self.path is not None:
                with open(self.path, "rb") as f:  # sniff the on-disk format
                    packed = f.read(4) == MAGIC
                self.graph = read_packed(self.path) if packed else read_metis(self.path)
            else:  # a foreign stream implementation: assemble its records
                self.graph = materialize_records(
                    self.stream.n, (rec[1:] for rec in self.stream)
                )
        return self.graph


def resolve_source(
    source: "CSRGraph | NodeStreamBase | ResolvedSource | str | os.PathLike",
    *,
    io_chunk_bytes: int | None = None,
) -> ResolvedSource:
    if isinstance(source, ResolvedSource):
        return source
    if isinstance(source, CSRGraph):
        return ResolvedSource(
            stream=NodeStream(source),
            graph=source,
            kind="graph",
            origin=f"CSRGraph(n={source.n}, m={source.m})",
        )
    if isinstance(source, NodeStream):
        return ResolvedSource(
            stream=source,
            graph=source._g,
            kind="stream",
            origin=f"NodeStream(n={source.n}, m={source.m})",
        )
    if isinstance(source, NodeStreamBase):
        return ResolvedSource(
            stream=source,
            graph=None,
            kind="stream",
            origin=f"{type(source).__name__}(n={source.n}, m={source.m})",
            path=getattr(source, "path", None),
        )
    if isinstance(source, (str, os.PathLike)):
        spec = os.fspath(source)
        if spec.startswith(GEN_PREFIX):
            g = build_generated(spec)
            return ResolvedSource(
                stream=NodeStream(g), graph=g, kind="generated", origin=spec
            )
        if not os.path.exists(spec):
            raise FileNotFoundError(
                f"graph source {spec!r} does not exist (expected a METIS text "
                f"or packed-binary file, or a '{GEN_PREFIX}<family>:...' spec)"
            )
        kw = {} if io_chunk_bytes is None else {"io_chunk_bytes": io_chunk_bytes}
        stream = DiskNodeStream(spec, **kw)
        return ResolvedSource(
            stream=stream,
            graph=None,
            kind="packed" if stream._packed else "metis",
            origin=spec,
            path=spec,
        )
    raise TypeError(
        f"cannot resolve a graph source from {type(source).__name__}: pass a "
        "CSRGraph, a NodeStream, a path to a METIS/packed file, or a "
        f"'{GEN_PREFIX}<family>:...' generator spec"
    )
