"""moonshot-v1-16b-a3b [moe] — 48L d=2048 16H (MHA kv=16) d_ff=1408
vocab=163840, MoE 64 fine-grained experts top-6 + 2 shared experts
(kimi/moonlight lineage) [hf:moonshotai/Moonlight-16B-A3B; hf].

Counterpart of `repro/configs/moonshot_v1_16b_a3b.py`, with the same field
values.  They make 28,888,467,456 parameters (57.78 GB in bf16), not the
16 B of the name: the expert count and width are the reference's."""
from repro_torch.configs.base import ArchSpec
from repro_torch.configs.lm_common import lm_input_specs, lm_shapes, lm_smoke_batch
from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "moonshot-v1-16b-a3b"


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab=163840, n_experts=64, top_k=6, n_shared_experts=2,
        dtype="bfloat16", q_chunk=512, kv_chunk=1024,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=48, vocab=512, n_experts=8, top_k=2,
        n_shared_experts=2, dtype="float32", q_chunk=16, kv_chunk=16,
    )


SPEC = ArchSpec(
    arch_id=ARCH_ID,
    family="lm",
    full_config=full_config,
    smoke_config=smoke_config,
    shapes=lm_shapes(full_attention_only=True),
    input_specs=lm_input_specs,
    smoke_batch=lambda cfg, seed=0: lm_smoke_batch(cfg, seed),
    notes="64-expert fine-grained MoE, top-6, 2 shared experts.",
)
