"""zamba2-7b — hybrid Mamba2 + shared attention blocks [arXiv:2411.15242].

81 layers: 3 leading mamba layers, then 13 repetitions of (5×mamba +
1 shared-attention layer).  The attention layer's weights are SHARED across
all 13 occurrences (one "bitstream", 13 tile placements — the paper's
operator-reuse case); each occurrence keeps its own KV cache.
"""

from repro_torch.configs.base import ArchConfig, register


@register("zamba2-7b")
def zamba2_7b() -> ArchConfig:
    return ArchConfig(
        name="zamba2-7b",
        family="hybrid",
        d_model=3584,
        num_heads=32,
        num_kv_heads=32,
        head_dim=112,
        d_ff=14336,
        vocab_size=32000,
        blocks=(
            (("mamba", "mamba", "mamba"), 1),
            (("mamba", "mamba", "mamba", "mamba", "mamba", "shared_attn"), 13),
        ),
        ssm_state=64,
        ssm_head_dim=64,
        ssm_expand=2,
        rope_theta=10_000.0,
        tie_embeddings=True,
    )
