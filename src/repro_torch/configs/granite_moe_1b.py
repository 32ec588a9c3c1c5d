"""granite-moe-1b-a400m — 32-expert top-8 MoE
[hf:ibm-granite/granite-3.0-1b-a400m-base].

24L, d_model 1024, 16 heads GQA kv=8, expert d_ff 512, vocab 49155.
"""

from repro_torch.configs.base import ArchConfig, register


@register("granite-moe-1b-a400m")
def granite_moe() -> ArchConfig:
    return ArchConfig(
        name="granite-moe-1b-a400m",
        family="moe",
        d_model=1024,
        num_heads=16,
        num_kv_heads=8,
        head_dim=64,
        d_ff=512,
        vocab_size=49_155,
        blocks=((("moe",), 24),),
        num_experts=32,
        experts_per_token=8,
        moe_d_ff=512,
        tie_embeddings=True,
        rope_theta=10_000.0,
    )
