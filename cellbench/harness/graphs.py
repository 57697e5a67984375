"""Input graphs of the benchmark, made from `--seed` in a few vectorised
torch passes on the run's device, and the stream orders a traffic mix may
ask for.

A graph is a `Graph` of four arrays in the CSR layout both sides read:
undirected and simple, every edge stored in both directions, neighbour
lists ascending, unit node and edge weights.  The program gets them
wrapped in its own container; the reference reads the arrays.
"""
from __future__ import annotations

import math
import typing

import numpy as np

ORDERS = ("natural", "random", "bfs")


class Graph(typing.NamedTuple):
    indptr: np.ndarray    # (n+1,) int64
    indices: np.ndarray   # (2m,) int32, ascending within a row
    edge_w: np.ndarray    # (2m,) float32
    node_w: np.ndarray    # (n,) float32

    @property
    def n(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def m(self) -> int:
        return int(self.indices.shape[0] // 2)


def torch_gen(seed: int, stream: int, device):
    """One independent generator on `device` per use (`stream`) of a run's
    seed; any whole number is a seed, negative ones and ones past 64 bits
    included."""
    import torch

    state = np.random.SeedSequence([seed % (1 << 64), stream]).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state) & ((1 << 63) - 1))
    return gen


def _ranges(starts, counts):
    """Concatenated aranges [starts[i], starts[i] + counts[i])."""
    import torch

    total = int(counts.sum())
    offs = torch.cumsum(counts, 0) - counts
    idx = torch.arange(total, device=counts.device)
    return idx - torch.repeat_interleave(offs - starts, counts, output_size=total)


def csr_from_pairs(n: int, src, dst) -> Graph:
    """The simple undirected graph on `n` nodes with edges {src[i], dst[i]}
    (torch tensors on any device): self-loops dropped, duplicates merged,
    unit weights."""
    import torch

    keep = src != dst
    lo = torch.minimum(src[keep], dst[keep])
    hi = torch.maximum(src[keep], dst[keep])
    key = torch.unique(lo * n + hi)
    lo, hi = key // n, key % n
    both = torch.sort(torch.cat([lo * n + hi, hi * n + lo])).values
    rows, cols = both // n, both % n
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=both.device)
    indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    cols = cols.to(torch.int32).cpu().numpy()
    return Graph(indptr.cpu().numpy(), cols, np.ones(cols.shape[0], dtype=np.float32),
                 np.ones(n, dtype=np.float32))


def rgg(n: int, radius_factor: float, seed: int, device="cpu") -> Graph:
    """Random geometric graph of the DIMACS10 challenge: `n` points uniform
    in the unit square, an edge between two points within the radius
    r = radius_factor * sqrt(ln n / n).  Nodes are numbered in the order of
    their grid cell of side >= r (row-major), and within a cell in the
    order drawn."""
    import torch

    r = radius_factor * math.sqrt(math.log(n) / n)
    pts = torch.rand((n, 2), generator=torch_gen(seed, 1, device), dtype=torch.float64,
                     device=device)
    side = max(int(1.0 / r), 1)  # cells per axis; each cell's side is >= r
    cxy = (pts * side).long().clamp(max=side - 1)
    cell, order = torch.sort(cxy[:, 1] * side + cxy[:, 0], stable=True)
    pts, cxy = pts[order], cxy[order]
    start = torch.searchsorted(cell, torch.arange(side * side + 1, device=device))
    srcs, dsts = [], []
    # each unordered pair of neighbouring cells once: the cell itself and
    # four of its eight neighbours
    for dx, dy in ((0, 0), (1, 0), (-1, 1), (0, 1), (1, 1)):
        ox, oy = cxy[:, 0] + dx, cxy[:, 1] + dy
        i = torch.nonzero((ox >= 0) & (ox < side) & (oy < side)).flatten()
        other = oy[i] * side + ox[i]
        cnt = start[other + 1] - start[other]
        a = torch.repeat_interleave(i, cnt)
        b = _ranges(start[other], cnt)
        if dx == 0 and dy == 0:
            keep = a < b
            a, b = a[keep], b[keep]
        d = pts[a] - pts[b]
        near = (d * d).sum(dim=1) <= r * r
        srcs.append(a[near])
        dsts.append(b[near])
    return csr_from_pairs(n, torch.cat(srcs), torch.cat(dsts))


def kronecker(scale: int, edgefactor: int, initiator, seed: int, device="cpu") -> Graph:
    """Graph500's Kronecker generator: edgefactor * 2^scale edge draws, each
    placing one bit of both endpoints a level with the initiator's
    probabilities (a, b, c, d).  Ids are left unpermuted."""
    import torch

    a, b, c, d = (float(x) for x in initiator)
    n = 1 << scale
    m = edgefactor * n
    gen = torch_gen(seed, 2, device)
    ab, c_norm, a_norm = a + b, c / (c + d), a / (a + b)
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    for level in range(scale):
        ii = torch.rand(m, generator=gen, dtype=torch.float64, device=device) > ab
        u = torch.rand(m, generator=gen, dtype=torch.float64, device=device)
        jj = u > torch.where(ii, c_norm, a_norm)
        src |= ii.long() << level
        dst |= jj.long() << level
    return csr_from_pairs(n, src, dst)


def relabel(g: Graph, order, device="cpu") -> Graph:
    """The graph streamed in `order`: node order[i] of `g` becomes node i."""
    import torch

    n = g.n
    order = torch.as_tensor(order, device=device)
    pos = torch.empty(n, dtype=torch.int64, device=device)
    pos[order] = torch.arange(n, device=device)
    indptr = torch.as_tensor(g.indptr, device=device)
    cols = torch.as_tensor(g.indices, device=device).long()
    rows = torch.repeat_interleave(torch.arange(n, device=device), torch.diff(indptr),
                                   output_size=cols.shape[0])
    up = rows < cols
    return csr_from_pairs(n, pos[rows[up]], pos[cols[up]])


def bfs_order(g: Graph) -> np.ndarray:
    """Breadth-first order: from the lowest unvisited node that has an
    edge, level by level, each level in the order its nodes were first
    reached; nodes without an edge last, by id."""
    n = g.n
    deg = np.diff(g.indptr)
    seen = deg == 0
    out = []
    nxt = 0
    while True:
        rest = np.nonzero(~seen[nxt:])[0]
        if rest.size == 0:
            break
        frontier = np.array([nxt + rest[0]], dtype=np.int64)
        nxt = int(frontier[0])
        seen[frontier] = True
        while frontier.size:
            out.append(frontier)
            cnt = deg[frontier]
            pos = np.arange(int(cnt.sum()), dtype=np.int64) - np.repeat(np.cumsum(cnt) - cnt, cnt)
            nb = g.indices[pos + np.repeat(g.indptr[frontier], cnt)].astype(np.int64)
            nb = nb[~seen[nb]]
            _, first = np.unique(nb, return_index=True)
            frontier = nb[np.sort(first)]
            seen[frontier] = True
    out.append(np.nonzero(deg == 0)[0])
    return np.concatenate(out).astype(np.int64)


def make_graph(config: dict, seed: int, device="cpu") -> Graph:
    """The configuration's graph from the seed, made on `device` (the same
    seed gives the same graph on one kind of device)."""
    kind = config["generator"]
    if kind == "rgg":
        return rgg(int(config["n"]), float(config["radius_factor"]), seed, device)
    if kind == "kronecker":
        return kronecker(int(config["scale"]), int(config["edgefactor"]),
                         config["initiator"], seed, device)
    raise ValueError(f"unknown generator {kind!r}: rgg or kronecker")


def stream_order(g: Graph, order: str, seed: int, device="cpu") -> Graph:
    """`g` renumbered into the traffic's stream order."""
    import torch

    if order == "natural":
        return g
    if order == "random":
        return relabel(g, torch.randperm(g.n, generator=torch_gen(seed, 3, device),
                                         device=device), device)
    if order == "bfs":
        return relabel(g, bfs_order(g), device)
    raise ValueError(f"unknown order {order!r}: one of {ORDERS}")
