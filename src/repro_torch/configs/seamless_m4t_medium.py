"""seamless-m4t-medium — enc-dec multimodal backbone [arXiv:2308.11596].

12 encoder + 12 decoder layers, d_model 1024, 16 heads (kv=16), d_ff 4096,
vocab 256206.  The audio frontend is a STUB: the inputs are precomputed
frame embeddings (B, S, 1024), which ``frontend_proj`` maps into the
encoder.
"""

from repro_torch.configs.base import ArchConfig, register


@register("seamless-m4t-medium")
def seamless_m4t() -> ArchConfig:
    return ArchConfig(
        name="seamless-m4t-medium",
        family="audio",
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab_size=256_206,
        encoder_blocks=((("enc",), 12),),
        blocks=((("dec",), 12),),
        frontend="audio",
        frontend_dim=1024,
        act="gelu",
        rope_theta=10_000.0,
    )
