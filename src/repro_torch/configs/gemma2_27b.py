"""gemma2-27b — local:global alternating attention, logit softcaps
[arXiv:2408.00118].

46L = 23×(local, global); sliding window 4096 on local layers; attention
softcap 50, final-logit softcap 30; query scaling by d_model/num_heads;
GeGLU; pre+post sublayer norms; tied embeddings scaled by sqrt(d_model).
``long_500k`` SKIPPED: half the layers are full-attention global.
"""

import math

from repro_torch.configs.base import ArchConfig, register


@register("gemma2-27b")
def gemma2_27b() -> ArchConfig:
    return ArchConfig(
        name="gemma2-27b",
        family="dense",
        d_model=4608,
        num_heads=32,
        num_kv_heads=16,
        head_dim=128,
        d_ff=36864,
        vocab_size=256_000,
        blocks=((("local", "global"), 23),),
        sliding_window=4096,
        attn_softcap=50.0,
        final_softcap=30.0,
        query_pre_attn_scalar=4608 / 32,  # d_model / num_heads = 144
        act="gelu",
        post_norms=True,
        tie_embeddings=True,
        embed_scale=math.sqrt(4608),
        rope_theta=10_000.0,
    )
