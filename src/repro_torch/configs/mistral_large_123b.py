"""mistral-large-123b — dense decoder [hf:mistralai/Mistral-Large-Instruct-2407].

88L, d_model 12288, 96 heads GQA kv=8, d_ff 28672, vocab 32768.
``long_500k`` is SKIPPED for this arch: pure full attention (see DESIGN.md §5).
"""

from repro_torch.configs.base import ArchConfig, register


@register("mistral-large-123b")
def mistral_large_123b() -> ArchConfig:
    return ArchConfig(
        name="mistral-large-123b",
        family="dense",
        d_model=12288,
        num_heads=96,
        num_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab_size=32768,
        blocks=((("dense",), 88),),
        rope_theta=1_000_000.0,
    )
