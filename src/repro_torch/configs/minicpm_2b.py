"""minicpm-2b — llama-like dense decoder with WSD schedule [arXiv:2404.06395].

40L, d_model 2304, 36 heads full MHA (kv=36), d_ff 5760, vocab 122753.
MiniCPM's μP-style stability tricks: embeddings scaled ×12, residual
branches scaled by 1.4/sqrt(num_layers), tied embeddings.  The WSD
(warmup-stable-decay) LR schedule lives in ``optim/schedules.py``.
"""

import math

from repro_torch.configs.base import ArchConfig, register


@register("minicpm-2b")
def minicpm_2b() -> ArchConfig:
    return ArchConfig(
        name="minicpm-2b",
        family="dense",
        d_model=2304,
        num_heads=36,
        num_kv_heads=36,
        head_dim=64,
        d_ff=5760,
        vocab_size=122_753,
        blocks=((("dense",), 40),),
        tie_embeddings=True,
        embed_scale=12.0,
        residual_scale=1.4 / math.sqrt(40),
        rope_theta=10_000.0,
    )
