"""mamba2-130m — pure SSM (SSD), attention-free [arXiv:2405.21060].

24L, d_model 768, ssm_state 128, vocab 50280 (gpt-neox tokenizer), no FFN
(the Mamba block subsumes it via expand=2).  Runs ``long_500k``: state is
O(1) per token.  num_heads/d_ff are placeholders — no attention layer exists.
"""

from repro_torch.configs.base import ArchConfig, register


@register("mamba2-130m")
def mamba2_130m() -> ArchConfig:
    return ArchConfig(
        name="mamba2-130m",
        family="ssm",
        d_model=768,
        num_heads=12,          # unused (attention-free)
        num_kv_heads=12,       # unused
        d_ff=0,                # no FFN sublayer
        vocab_size=50_280,
        blocks=((("mamba",), 24),),
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        tie_embeddings=True,
    )
