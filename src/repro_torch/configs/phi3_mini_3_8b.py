"""phi3-mini-3.8b — dense decoder, RoPE + SwiGLU + GQA [arXiv:2404.14219].

32L, d_model 3072, 32 heads (kv=32 — full MHA), d_ff 8192, vocab 32064.
"""

from repro_torch.configs.base import ArchConfig, register


@register("phi3-mini-3.8b")
def phi3_mini() -> ArchConfig:
    return ArchConfig(
        name="phi3-mini-3.8b",
        family="dense",
        d_model=3072,
        num_heads=32,
        num_kv_heads=32,
        head_dim=96,
        d_ff=8192,
        vocab_size=32064,
        blocks=((("dense",), 32),),
        rope_theta=10_000.0,
    )
