"""dlrm-mlperf [recsys] — MLPerf DLRM benchmark config (Criteo 1TB)
[arXiv:1906.00091]: 13 dense + 26 sparse features, embed_dim=128,
bot MLP 13-512-256-128, top MLP 1024-1024-512-256-1, dot interaction.

Counterpart of `repro/configs/dlrm_mlperf.py`, with the same field values:
a uniform 2^20-row stand-in per table (DESIGN.md §7), so the stacked
tables are 26 × 1,048,576 × 128 float32 (13.96 GB) and fit one H100 whole.
Every forward pools the 26 lookups through the `embedding_bag` CUDA kernel
(`repro_torch/kernels/embedding_bag.py`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchSpec, ShapeDef
from repro_torch.models.dlrm import DLRMConfig

ARCH_ID = "dlrm-mlperf"
F32, I32 = torch.float32, torch.int32


def full_config() -> DLRMConfig:
    return DLRMConfig(
        name=ARCH_ID, n_dense=13, n_sparse=26, embed_dim=128,
        vocab_size=1_048_576, bot_mlp=(512, 256, 128),
        top_mlp=(1024, 1024, 512, 256, 1), multi_hot=1,
    )


def smoke_config() -> DLRMConfig:
    return DLRMConfig(
        name=ARCH_ID + "-smoke", n_dense=13, n_sparse=4, embed_dim=16,
        vocab_size=128, bot_mlp=(32, 16), top_mlp=(32, 16, 1), multi_hot=2,
    )


SHAPES = {
    "train_batch": ShapeDef("train_batch", "train", {"batch": 65536}),
    "serve_p99": ShapeDef("serve_p99", "serve", {"batch": 512}),
    "serve_bulk": ShapeDef("serve_bulk", "serve", {"batch": 262144}),
    "retrieval_cand": ShapeDef(
        "retrieval_cand", "retrieval", {"batch": 1, "candidates": 1_000_000}
    ),
}


def input_specs(cfg: DLRMConfig, shape: ShapeDef) -> dict:
    """`(shape, dtype)` of every input of the step `shape.kind`."""
    b = shape.dims["batch"]
    m = cfg.multi_hot
    if shape.kind == "retrieval":
        n_cand = shape.dims["candidates"]
        return {
            "query_dense": ((1, cfg.n_dense), F32),
            "query_sparse_idx": ((1, cfg.n_sparse, m), I32),
            "query_sparse_mask": ((1, cfg.n_sparse, m), F32),
            "candidates": ((n_cand, cfg.embed_dim), F32),
        }
    specs = {
        "dense": ((b, cfg.n_dense), F32),
        "sparse_idx": ((b, cfg.n_sparse, m), I32),
        "sparse_mask": ((b, cfg.n_sparse, m), F32),
    }
    if shape.kind == "train":
        specs["labels"] = ((b,), I32)
    return specs


def draw_batch(cfg: DLRMConfig, rows: int, seed: int = 0) -> dict:
    """A batch of `rows` samples by the reference's numpy recipe: dense
    features standard normal, every lookup uniform over the vocabulary,
    every mask slot on, labels 0 or 1 (CPU tensors)."""
    rng = np.random.default_rng(seed)
    m = cfg.multi_hot
    return {
        "dense": torch.from_numpy(rng.standard_normal((rows, cfg.n_dense)).astype(np.float32)),
        "sparse_idx": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (rows, cfg.n_sparse, m)).astype(np.int32)),
        "sparse_mask": torch.ones((rows, cfg.n_sparse, m), dtype=F32),
        "labels": torch.from_numpy(rng.integers(0, 2, rows).astype(np.int32)),
    }


def smoke_batch(cfg: DLRMConfig, seed: int = 0) -> dict:
    """The reference's 16-row smoke batch (the same numpy draws)."""
    return draw_batch(cfg, 16, seed)


SPEC = ArchSpec(
    arch_id=ARCH_ID,
    family="recsys",
    full_config=full_config,
    smoke_config=smoke_config,
    shapes=SHAPES,
    input_specs=input_specs,
    smoke_batch=smoke_batch,
    notes="Embedding lookup is the hot path — kernels/embedding_bag, one launch per forward.",
)
