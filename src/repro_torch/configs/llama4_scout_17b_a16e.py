"""llama4-scout-17b-a16e [moe] — 48L d=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 + 1 shared expert, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

Counterpart of `repro/configs/llama4_scout_17b_a16e.py`, with the same
field values (107.8 B parameters, 215.5 GB in bf16: more than one card
holds).  Early-fusion multimodality: the vision frontend is a stub, as in
the reference; the inputs are token ids."""
from repro_torch.configs.base import ArchSpec
from repro_torch.configs.lm_common import lm_input_specs, lm_shapes, lm_smoke_batch
from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "llama4-scout-17b-a16e"


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=8192, vocab=202048, n_experts=16, top_k=1, n_shared_experts=1,
        dtype="bfloat16", q_chunk=512, kv_chunk=1024,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=96, vocab=512, n_experts=4, top_k=1,
        n_shared_experts=1, dtype="float32", q_chunk=16, kv_chunk=16,
    )


SPEC = ArchSpec(
    arch_id=ARCH_ID,
    family="lm",
    full_config=full_config,
    smoke_config=smoke_config,
    shapes=lm_shapes(full_attention_only=True),
    input_specs=lm_input_specs,
    smoke_batch=lambda cfg, seed=0: lm_smoke_batch(cfg, seed),
    notes="MoE 16e top-1 + shared; early-fusion frontend stubbed.",
)
