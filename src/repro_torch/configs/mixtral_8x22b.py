"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]
(``repro.configs.mixtral_8x22b``)"""

from repro_torch.configs.lm_common import LMArch
from repro_torch.models.transformer import MoESpec, TransformerConfig

_WINDOW = 4096


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name="mixtral-8x22b", n_layers=56, d_model=6144, n_heads=48,
        n_kv_heads=8, d_head=128, d_ff=16384, vocab=32768,
        rope_theta=1_000_000.0, layer_windows=(_WINDOW,),
        tie_embeddings=False, dtype="bfloat16",
        moe=MoESpec(n_experts=8, top_k=2, d_ff_expert=16384,
                    softmax_after_topk=True),
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="mixtral-8x22b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab=512, layer_windows=(16,),
        tie_embeddings=False, dtype="float32", remat=False,
        moe=MoESpec(n_experts=4, top_k=2, d_ff_expert=96,
                    softmax_after_topk=True),
    )


ARCH = LMArch(
    arch_id="mixtral-8x22b",
    full_config=full_config,
    smoke_config=smoke_config,
    # SWA makes prefill sub-quadratic; decode is O(window) -> long_500k runs.
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)
