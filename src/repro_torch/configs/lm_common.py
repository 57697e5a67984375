"""Shared shape definitions and input specs for the LM transformer archs
(counterpart of `repro/configs/lm_common.py`)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ShapeDef
from repro_torch.models.transformer import TransformerConfig, init_cache


def lm_shapes(full_attention_only: bool) -> dict[str, ShapeDef]:
    """The four assigned LM shapes; long_500k is skipped for pure
    full-attention archs (it needs sub-quadratic attention)."""
    skip = (
        "pure full-attention arch: 512k decode needs sub-quadratic attention "
        "(SWA/SSM); skipped per assignment, see DESIGN.md §5"
        if full_attention_only
        else None
    )
    return {
        "train_4k": ShapeDef("train_4k", "train", {"seq": 4096, "batch": 256}),
        "prefill_32k": ShapeDef("prefill_32k", "prefill", {"seq": 32768, "batch": 32}),
        "decode_32k": ShapeDef("decode_32k", "decode", {"seq": 32768, "batch": 128}),
        "long_500k": ShapeDef("long_500k", "decode", {"seq": 524288, "batch": 1}, skip=skip),
    }


def lm_input_specs(cfg: TransformerConfig, shape: ShapeDef) -> dict:
    """`(shape, dtype)` of every input of the step `shape.kind`."""
    b, s = shape.dims["batch"], shape.dims["seq"]
    i32 = torch.int32
    if shape.kind == "train":
        return {"tokens": ((b, s), i32), "labels": ((b, s), i32)}
    if shape.kind == "prefill":
        return {"tokens": ((b, s), i32)}
    if shape.kind == "decode":
        cache_shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.d_head)
        return {
            "tokens": ((b, 1), i32),
            "cache": {
                "k": (cache_shape, cfg.torch_dtype),
                "v": (cache_shape, cfg.torch_dtype),
                "pos": ((b,), i32),
            },
        }
    raise ValueError(shape.kind)


def lm_smoke_batch(cfg: TransformerConfig, seed: int = 0) -> dict:
    """Small real train batch for the reduced config (the reference's
    numpy draws, so both packages see the same tokens)."""
    rng = np.random.default_rng(seed)
    b, s = 2, 32
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return {
        "tokens": torch.from_numpy(toks),
        "labels": torch.from_numpy(np.roll(toks, -1, axis=1)),
    }


def lm_smoke_decode_state(cfg: TransformerConfig, batch: int = 2, max_len: int = 64,
                          device: str | torch.device = "cuda") -> dict:
    return init_cache(cfg, batch, max_len, device=device)
