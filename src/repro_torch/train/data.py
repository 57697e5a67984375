"""Deterministic synthetic data pipelines (counterpart of
`repro/train/data.py`).

The same numpy draws as the reference, seeded per (seed, step, shard), so
restarts replay identically and the values equal the reference's; each
batch's tensors are placed on the caller's `device`.
"""
from __future__ import annotations

from collections.abc import Callable, Iterator

import numpy as np
import torch

from repro_torch.tree import tree_map


def _to_device(batch, device: str | torch.device):
    """The batch's tensors on `device`; other leaves (counts) as they are."""
    return tree_map(lambda x: x.to(device) if isinstance(x, torch.Tensor) else x, batch)


def token_batches(
    vocab: int, batch: int, seq: int, *, seed: int = 0, steps: int | None = None,
    shard: int = 0, n_shards: int = 1, device: str | torch.device = "cuda",
) -> Iterator[dict]:
    """Zipf-ish synthetic token stream (power-law unigram: a cheap stand-in
    with a realistic softmax loss landscape)."""
    step = 0
    probs = 1.0 / np.arange(1, vocab + 1) ** 1.1
    probs /= probs.sum()
    while steps is None or step < steps:
        rng = np.random.default_rng((seed, step, shard))
        toks = rng.choice(vocab, size=(batch // n_shards, seq + 1), p=probs)
        yield {
            "tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)).to(device),
            "labels": torch.from_numpy(toks[:, 1:].astype(np.int32)).to(device),
        }
        step += 1


def gnn_batches(
    smoke_batch_fn: Callable[[int], dict], *, seed: int = 0, steps: int | None = None,
    device: str | torch.device = "cuda",
) -> Iterator[dict]:
    """smoke_batch_fn(seed + step) for step = 0, 1, ..., on `device`."""
    step = 0
    while steps is None or step < steps:
        yield _to_device(smoke_batch_fn(seed + step), device)
        step += 1


def dlrm_batches(
    cfg, batch: int, *, seed: int = 0, steps: int | None = None,
    device: str | torch.device = "cuda",
) -> Iterator[dict]:
    step = 0
    while steps is None or step < steps:
        rng = np.random.default_rng((seed, step))
        m = cfg.multi_hot
        dense = rng.standard_normal((batch, cfg.n_dense)).astype(np.float32)
        idx = rng.integers(0, cfg.vocab_size, (batch, cfg.n_sparse, m)).astype(np.int32)
        labels = rng.integers(0, 2, batch).astype(np.int32)
        yield {
            "dense": torch.from_numpy(dense).to(device),
            "sparse_idx": torch.from_numpy(idx).to(device),
            "sparse_mask": torch.ones((batch, cfg.n_sparse, m), dtype=torch.float32,
                                      device=device),
            "labels": torch.from_numpy(labels).to(device),
        }
        step += 1
