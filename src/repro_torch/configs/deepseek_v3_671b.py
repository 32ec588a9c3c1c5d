"""deepseek-v3-671b — MLA + 256-expert top-8 MoE + MTP [arXiv:2412.19437].

61L: 3 dense (d_ff 18432) then 58 MoE layers (1 shared + 256 routed experts,
top-8, per-expert d_ff 2048 — the assigned table's "d_ff=2048").  MLA:
q_lora 1536, kv_lora 512, qk_nope 128, qk_rope 64, v_head 128.  Sigmoid
router scoring (aux-loss-free balancing's gating function; the bias-update
machinery is replaced by the standard aux metric — noted in DESIGN.md).
Multi-token prediction depth 1.
"""

from repro_torch.configs.base import ArchConfig, register


@register("deepseek-v3-671b")
def deepseek_v3() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v3-671b",
        family="moe",
        d_model=7168,
        num_heads=128,
        num_kv_heads=128,
        d_ff=18432,               # dense prologue layers
        vocab_size=129_280,
        blocks=(
            (("mla_dense",), 3),
            (("mla_moe",), 58),
        ),
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        num_experts=256,
        experts_per_token=8,
        moe_d_ff=2048,
        num_shared_experts=1,
        router_scoring="sigmoid",
        mtp_depth=1,
        rope_theta=10_000.0,
    )
