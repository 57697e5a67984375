"""command-r-plus-104b [dense] — 64L d=12288 96H (GQA kv=8) d_ff=33792
vocab=256000, no-bias [hf:CohereForAI/c4ai-command-r-v01; unverified].

Counterpart of `repro/configs/command_r_plus_104b.py`, with the same
field values (107.0 B parameters, 213.9 GB in bf16: more than one card
holds)."""
from repro_torch.configs.base import ArchSpec
from repro_torch.configs.lm_common import lm_input_specs, lm_shapes, lm_smoke_batch
from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "command-r-plus-104b"


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8,
        d_ff=33792, vocab=256000, dtype="bfloat16", q_chunk=512, kv_chunk=1024,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=96, n_heads=6,
        n_kv_heads=2, d_ff=256, vocab=512, dtype="float32",
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
    notes="Largest dense arch: FSDP+TP required to fit (DESIGN.md §6).",
)
