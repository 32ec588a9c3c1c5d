"""Registration of the architectures the port serves, the paper's own
VMUL&Reduce workload constants, and the smoke-test reduction helper.

A copy of ``repro/configs/archs.py``: all ten of its architectures are
registered — phi3-mini-3.8b, mamba2-130m, the dense family (gemma2-27b,
minicpm-2b, mistral-large-123b), the hybrid zamba2-7b, the
mixture-of-experts granite-moe-1b-a400m, deepseek-v3-671b (Multi-head
Latent Attention and a 256-expert FFN), the encoder-decoder
seamless-m4t-medium (its audio frontend a stub of frame embeddings) and
the vlm pixtral-12b (its vision frontend a stub of patch embeddings).
:func:`cut_layers` is the port's own: a full-width config cut to fewer
layers, for a model whose full depth does not fit one card.
"""

from __future__ import annotations

from repro_torch.configs import (  # noqa: F401  (registers)
    deepseek_v3_671b, gemma2_27b, granite_moe_1b, mamba2_130m, minicpm_2b,
    mistral_large_123b, phi3_mini_3_8b, pixtral_12b, seamless_m4t_medium, zamba2_7b)
from repro_torch.configs.base import ArchConfig, get_config

# ---------------------------------------------------------------------------
# The paper's own workload (vmul+reduce) as a "config" for the benchmarks
# ---------------------------------------------------------------------------
PAPER_DATA_BYTES = 16 * 1024          # §III: "data size was set to 16 KBytes"
PAPER_VECTOR_LEN = PAPER_DATA_BYTES // 4   # f32 elements per input vector


# ---------------------------------------------------------------------------
# Reduced configs for CPU smoke tests — same family, tiny dims
# ---------------------------------------------------------------------------
def _shrink_blocks(blocks, max_rep=2):
    return tuple((unit, min(rep, max_rep)) for unit, rep in blocks)


def smoke_config(name: str) -> ArchConfig:
    """A tiny same-family config: every layer kind of the original appears."""
    cfg = get_config(name)
    heads = min(cfg.num_heads, 4)
    kv = min(cfg.num_kv_heads, heads)
    d_model = 64
    over = dict(
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        blocks=_shrink_blocks(cfg.blocks),
        encoder_blocks=_shrink_blocks(cfg.encoder_blocks),
        embed_scale=min(cfg.embed_scale, 8.0),
    )
    if cfg.query_pre_attn_scalar is not None:
        over["query_pre_attn_scalar"] = d_model / heads
    if cfg.num_experts:
        over.update(num_experts=4, experts_per_token=2, moe_d_ff=32,
                    capacity_factor=4.0)
    if cfg.kv_lora_rank:
        over.update(q_lora_rank=32, kv_lora_rank=16,
                    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
    if cfg.ssm_state:
        over.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
    if cfg.frontend_dim:
        over["frontend_dim"] = 32
    return cfg.scaled(**over)


def cut_layers(cfg: ArchConfig, layers: int) -> ArchConfig:
    """``cfg`` at full width with only its first ``layers`` decoder layers:
    each group keeps as many whole repeats of its unit as fit.  ``layers``
    must be a whole number of units (gemma2's unit is two layers)."""
    blocks, left = [], layers
    for unit, rep in cfg.blocks:
        keep = min(rep, left // len(unit))
        if keep:
            blocks.append((unit, keep))
        left -= keep * len(unit)
    if left or not blocks:
        raise ValueError(f"{cfg.name}: {layers} layers is not a whole number "
                         f"of its units {[u for u, _ in cfg.blocks]} (at most "
                         f"{cfg.num_layers})")
    return cfg.scaled(blocks=tuple(blocks))
