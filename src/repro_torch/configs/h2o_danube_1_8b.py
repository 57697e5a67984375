"""h2o-danube-1.8b [dense] — 24L d=2560 32H (GQA kv=8) d_ff=6912 vocab=32000,
llama+mistral mix with sliding-window attention [arXiv:2401.16818; hf].

The LM arch with sub-quadratic attention (SWA, window 4096): every decode
step of every layer runs the sliding-window decode kernel
(`repro_torch/kernels/swa_attention.py`).  Counterpart of
`repro/configs/h2o_danube_1_8b.py`, with the same field values."""
from repro_torch.configs.base import ArchSpec
from repro_torch.configs.lm_common import lm_input_specs, lm_shapes, lm_smoke_batch
from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "h2o-danube-1.8b"


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
        d_ff=6912, vocab=32000, sliding_window=4096, dtype="bfloat16",
        q_chunk=512, kv_chunk=1024,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=160, vocab=512, sliding_window=16,
        dtype="float32", q_chunk=16, kv_chunk=16,
    )


SPEC = ArchSpec(
    arch_id=ARCH_ID,
    family="lm",
    full_config=full_config,
    smoke_config=smoke_config,
    shapes=lm_shapes(full_attention_only=False),  # SWA: long_500k runs
    input_specs=lm_input_specs,
    smoke_batch=lambda cfg, seed=0: lm_smoke_batch(cfg, seed),
    notes="SWA window 4096; decode attends to O(window) positions through the CUDA kernel.",
)
