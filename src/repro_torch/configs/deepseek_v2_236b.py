"""deepseek-v2-236b [moe]: 60L d_model=5120 128H MLA (kv_lora=512) d_ff=1536,
160 routed experts top-6 + 2 shared experts, vocab=102400.
[arXiv:2405.04434; hf]

The reference's simplification, kept: the published model's first layer
uses a dense FFN (12288); here every layer is MoE (one uniform pattern).
(``repro.configs.deepseek_v2_236b``)"""

from repro_torch.configs.lm_common import LMArch
from repro_torch.models.mla import MLAConfig
from repro_torch.models.transformer import MoESpec, TransformerConfig


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name="deepseek-v2-236b", n_layers=60, d_model=5120, n_heads=128,
        n_kv_heads=128, d_head=128, d_ff=1536, vocab=102400,
        rope_theta=10000.0, tie_embeddings=False, dtype="bfloat16",
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        moe=MoESpec(n_experts=160, top_k=6, d_ff_expert=1536,
                    n_shared=2, d_ff_shared=3072),
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="deepseek-v2-236b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_ff=64, vocab=512, tie_embeddings=False,
        dtype="float32", remat=False,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
        moe=MoESpec(n_experts=8, top_k=2, d_ff_expert=32, n_shared=2,
                    d_ff_shared=64),
    )


ARCH = LMArch(
    arch_id="deepseek-v2-236b",
    full_config=full_config,
    smoke_config=smoke_config,
    # MLA decode reads a 576-float/token latent cache: long_500k runs.
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)
