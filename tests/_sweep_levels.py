"""Coarsest levels for `_initial_fennel` whose free nodes come in an order
where a node is often a neighbour of the node before it, shared by the
sweep kernel's card tests (`test_torch_cuda.py`) and the CPU tests that
hold the sweep's plain version against the reference
(`test_torch_multilevel.py`).  It imports no jax: the card tests do not.

Each level is a path or a row-major mesh of side x side nodes whose node
weights fall along the ids, so `_initial_fennel`'s order (weight
descending, id ascending) walks the path or the mesh's rows; every fifth
node is pinned to a random block.  The kinds:

- "path", "mesh": integer edge weights 1-3;
- "int40": the mesh with integer weights up to 2^40;
- "mixed": the mesh where an even node's segment is integral and an odd
  node's fractional (uniform(0.5, 2.0)), so the two alternate in one sweep;
- "long": the mesh plus 6-40 random edges a node and a hub of 900 (every
  segment past the kernel's 8 short entries, none past its 1024 staged
  ones), with the weights of "mixed";
- "ties": zero edge weights, unit node weights, nothing pinned, so every
  block ties at the first step and the least-loaded ones at every step;
- "infeasible": the mesh with a cap at 60% of the average load, so the
  later steps (and at k = 31 or 32 the heavier nodes) find no feasible
  block;
- "single": one free node.
"""
import numpy as np

from repro_torch.graphs.csr import bucket_size

KINDS = ("path", "mesh", "int40", "mixed", "long", "ties", "infeasible", "single")


def chained_level(kind: str, k: int, seed: int, side: int):
    """(esrc, edst, ew, node_w, pinned) as numpy arrays, n, n_free, loads0,
    cap and w_c, in the form `_initial_fennel` takes them."""
    rng = np.random.default_rng(seed)
    n = side * side
    ids = np.arange(n)
    if kind == "path":
        pairs = np.stack([ids[:-1], ids[1:]], 1)
    else:
        right = ids[(ids % side) < side - 1]
        down = ids[ids < n - side]
        pairs = np.concatenate([np.stack([right, right + 1], 1), np.stack([down, down + side], 1)])
    src = np.concatenate([pairs[:, 0], pairs[:, 1]])
    dst = np.concatenate([pairs[:, 1], pairs[:, 0]])
    if kind == "long":
        extra = rng.integers(6, 41, n)
        hub = 5
        extra[hub] = 900
        xs = np.repeat(ids, extra)
        xd = rng.integers(0, n, xs.size)
        keep = xs != xd
        src, dst = np.concatenate([src, xs[keep]]), np.concatenate([dst, xd[keep]])
    by_src = np.lexsort((dst, src))
    src, dst = src[by_src], dst[by_src]
    e = src.size
    if kind == "int40":
        w = rng.integers(1, 2**40 + 1, e).astype(np.float64)
    elif kind in ("mixed", "long"):
        w = np.where(src % 2 == 0, rng.integers(1, 4, e), rng.uniform(0.5, 2.0, e))
    elif kind == "ties":
        w = np.zeros(e)
    else:
        w = rng.integers(1, 4, e).astype(np.float64)
    n_pad = bucket_size(n + 1)
    e_pad = bucket_size(e)
    esrc, edst = np.full(e_pad, n_pad), np.full(e_pad, n_pad)
    esrc[:e], edst[:e] = src, dst
    ew = np.zeros(e_pad)
    ew[:e] = w
    node_w = np.zeros(n_pad)
    node_w[:n] = 1.0 if kind == "ties" else (n - ids) % 97 + n // 97 + 1.0
    if kind != "ties":  # weights fall along the ids: the order walks them
        node_w[:n] = np.sort(node_w[:n])[::-1]
    pinned = np.full(n_pad, -2)
    pinned[:n] = -1
    if kind == "single":
        pinned[:n] = rng.integers(0, k, n)
        pinned[n // 2] = -1
    elif kind != "ties":
        pin = ids[ids % 5 == 3]
        pinned[pin] = rng.integers(0, k, pin.size)
    held = pinned[:n] >= 0
    loads0 = np.bincount(pinned[:n][held], weights=node_w[:n][held], minlength=k)
    free = pinned[:n] == -1
    cap = node_w[:n].sum() / k
    cap = 0.6 * cap if kind == "infeasible" else 1.05 * cap + node_w[:n].max()
    deg = np.bincount(src, minlength=n)
    w_c = min(bucket_size(int(deg[free].max()), minimum=64), e_pad)
    return ((esrc, edst, ew, node_w, pinned), n, int(free.sum()), loads0.astype(np.float64),
            float(cap), w_c)
