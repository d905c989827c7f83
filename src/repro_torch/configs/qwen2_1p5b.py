"""qwen2-1.5b [dense]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — GQA with QKV bias.  [arXiv:2407.10671; hf]
(``repro.configs.qwen2_1p5b``)"""

from repro_torch.configs.lm_common import LMArch
from repro_torch.models.transformer import TransformerConfig


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-1.5b", n_layers=28, d_model=1536, n_heads=12,
        n_kv_heads=2, d_head=128, d_ff=8960, vocab=151936,
        rope_theta=1_000_000.0, qkv_bias=True, tie_embeddings=True,
        dtype="bfloat16",
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-1.5b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=160, vocab=512, qkv_bias=True,
        tie_embeddings=True, dtype="float32", remat=False,
    )


ARCH = LMArch(
    arch_id="qwen2-1.5b",
    full_config=full_config,
    smoke_config=smoke_config,
    # Pure full-attention GQA: long_500k skipped per assignment rule
    # ("needs sub-quadratic attention — skip for pure full-attention archs").
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    skip_notes={"long_500k": "pure full-attention arch (assignment rule)"},
)
