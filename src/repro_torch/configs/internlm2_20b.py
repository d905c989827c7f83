"""internlm2-20b [dense]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544 — GQA.  [arXiv:2403.17297; hf]
(``repro.configs.internlm2_20b``)"""

from repro_torch.configs.lm_common import LMArch
from repro_torch.models.transformer import TransformerConfig


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name="internlm2-20b", n_layers=48, d_model=6144, n_heads=48,
        n_kv_heads=8, d_head=128, d_ff=16384, vocab=92544,
        rope_theta=1_000_000.0, tie_embeddings=False, dtype="bfloat16",
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="internlm2-20b-smoke", n_layers=2, d_model=96, n_heads=6,
        n_kv_heads=2, d_head=16, d_ff=256, vocab=512, tie_embeddings=False,
        dtype="float32", remat=False,
    )


ARCH = LMArch(
    arch_id="internlm2-20b",
    full_config=full_config,
    smoke_config=smoke_config,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    skip_notes={"long_500k": "pure full-attention arch (assignment rule)"},
)
