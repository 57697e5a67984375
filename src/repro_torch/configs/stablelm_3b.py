"""stablelm-3b [dense] — 32L d=2560 32H (MHA kv=32) d_ff=6912 vocab=50304
[hf:stabilityai/stablelm-2-1_6b; unverified].

Counterpart of `repro/configs/stablelm_3b.py`, with the same field values
(2.80 B parameters, 5.59 GB in bf16)."""
from repro_torch.configs.base import ArchSpec
from repro_torch.configs.lm_common import lm_input_specs, lm_shapes, lm_smoke_batch
from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "stablelm-3b"


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
        d_ff=6912, vocab=50304, dtype="bfloat16", q_chunk=512, kv_chunk=1024,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=160, vocab=512, dtype="float32",
        q_chunk=16, kv_chunk=16,
    )


SPEC = ArchSpec(
    arch_id=ARCH_ID,
    family="lm",
    full_config=full_config,
    smoke_config=smoke_config,
    shapes=lm_shapes(full_attention_only=True),
    input_specs=lm_input_specs,
    smoke_batch=lambda cfg, seed=0: lm_smoke_batch(cfg, seed),
)
