"""pixtral-12b — pixtral-ViT frontend + mistral-nemo text backbone
[hf:mistralai/Pixtral-12B-2409].

40L, d_model 5120, 32 heads GQA kv=8, d_ff 14336, vocab 131072.  The vision
frontend is a STUB: the inputs are precomputed patch embeddings (B, 256,
1024), which ``frontend_proj`` maps into the first 256 token slots of the
decoder's input (``models.transformer.forward(patch_embeds=)``).
"""

from repro_torch.configs.base import ArchConfig, register


@register("pixtral-12b")
def pixtral_12b() -> ArchConfig:
    return ArchConfig(
        name="pixtral-12b",
        family="vlm",
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=131_072,
        blocks=((("dense",), 40),),
        frontend="vision",
        frontend_dim=1024,
        rope_theta=1_000_000.0,
    )
