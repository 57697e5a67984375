"""Fanout neighbor sampler (GraphSAGE minibatch training, shape
minibatch_lg); counterpart of `repro/graphs/sampler.py`.

Produces fixed-shape sampled blocks: for a seed batch of size B and fanouts
(f1, f2, ...), hop h yields a (B * prod(f_1..f_h),) node array with repeats
(isolated nodes sample themselves), so every downstream tensor has a static
shape.

Partition-aware mode (BuffCut integration): when `block_of` is given, the
sampler prefers neighbors in the same partition block, reducing
cross-device feature gathers, the systems payoff of low-cut streaming
partitions.

Host numpy.  The draws are the reference's `Generator` calls in the
reference's order, so the sampled layers are bit-identical to its own for
the same seed.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.csr import CSRGraph


def sample_block(
    g: CSRGraph,
    seeds: np.ndarray,
    fanout: int,
    *,
    rng: np.random.Generator,
    block_of: np.ndarray | None = None,
    same_block_bias: float = 4.0,
) -> np.ndarray:
    """Sample `fanout` neighbors per seed -> (len(seeds)*fanout,) int64.

    Sampling is with replacement; isolated nodes sample themselves.
    """
    seeds = np.asarray(seeds, dtype=np.int64)
    out = np.empty((seeds.shape[0], fanout), dtype=np.int64)
    for i, v in enumerate(seeds):
        nbrs = g.neighbors(v)
        if nbrs.size == 0:
            out[i, :] = v
            continue
        if block_of is not None:
            w = np.where(block_of[nbrs] == block_of[v], same_block_bias, 1.0)
            p = w / w.sum()
            out[i, :] = rng.choice(nbrs, size=fanout, replace=True, p=p)
        else:
            out[i, :] = nbrs[rng.integers(0, nbrs.size, size=fanout)]
    return out.reshape(-1)


def sample_multihop(
    g: CSRGraph,
    seeds: np.ndarray,
    fanouts: tuple[int, ...],
    *,
    seed: int = 0,
    block_of: np.ndarray | None = None,
) -> list[np.ndarray]:
    """Multi-hop sampling; returns [seeds, hop1, hop2, ...] node-id arrays."""
    rng = np.random.default_rng(seed)
    layers = [np.asarray(seeds, dtype=np.int64)]
    frontier = layers[0]
    for f in fanouts:
        frontier = sample_block(g, frontier, f, rng=rng, block_of=block_of)
        layers.append(frontier)
    return layers


def cross_block_fraction(
    g: CSRGraph, layers: list[np.ndarray], block_of: np.ndarray
) -> float:
    """Fraction of sampled (parent, child) pairs crossing partition blocks,
    i.e. the fraction of feature gathers that hit the network."""
    total, cross = 0, 0
    for h in range(len(layers) - 1):
        parents = layers[h]
        children = layers[h + 1].reshape(parents.shape[0], -1)
        pb = block_of[parents][:, None]
        cb = block_of[children]
        total += children.size
        cross += int((pb != cb).sum())
    return cross / max(total, 1)
