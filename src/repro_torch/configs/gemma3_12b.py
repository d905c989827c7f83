"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144 — 5:1 local:global interleaved attention, 1024-token sliding
window on local layers.  [hf:google/gemma-3-12b-pt; unverified]
(``repro.configs.gemma3_12b``)"""

from repro_torch.configs.lm_common import LMArch
from repro_torch.models.transformer import TransformerConfig

_WINDOW = 1024
_PATTERN = (_WINDOW,) * 5 + (None,)      # 5 local : 1 global


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name="gemma3-12b", n_layers=48, d_model=3840, n_heads=16,
        n_kv_heads=8, d_head=256, d_ff=15360, vocab=262144,
        rope_theta=1_000_000.0, layer_windows=_PATTERN, tie_embeddings=True,
        dtype="bfloat16",
    )


def smoke_config() -> TransformerConfig:
    # The reference's smoke config: a 1:1 local:global pattern keeps both
    # attention kinds covered at 2 layers; the 5:1 ratio is full_config's.
    return TransformerConfig(
        name="gemma3-12b-smoke", n_layers=2, d_model=48, n_heads=4,
        n_kv_heads=2, d_head=12, d_ff=96, vocab=256,
        layer_windows=(16, None), tie_embeddings=True,
        dtype="float32", remat=False,
    )


ARCH = LMArch(
    arch_id="gemma3-12b",
    full_config=full_config,
    smoke_config=smoke_config,
    # long_500k runs: the 5:1 sliding:global hybrid is sub-quadratic in the
    # sliding layers and decode is O(S) per token.
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)
