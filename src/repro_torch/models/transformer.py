"""The decoder stack: embedding, a Python loop over the layers, the head.

Port of the dense (with gemma2's local/global layers and post-sublayer
norms), mixture-of-experts (``moe``: attention + :mod:`repro_torch.models.
moe`), MLA (deepseek-v3's ``mla_dense`` and ``mla_moe``: Multi-head Latent
Attention + the MLP or the MoE FFN), Mamba-2 and hybrid (zamba2's
``shared_attn``) paths of
``repro/models/transformer.py``.  The reference scans each block of
stacked layers (``transformer.py:179-222``); the port walks the layers of
``params.layer_plan``: each layer's kind and where its weights are, its own
dict of ``params["layers"]`` or its group's shared set (every
``shared_attn`` occurrence of a group reads the one set, as the
reference's scan body reads ``shared["shared_attn"]``, ``transformer.py:
182-190``).  Caches are one dict per layer, shared_attn occurrences
included: ``{"k", "v", "index"}`` for an attention layer, the latent
``{"c_kv", "k_rope", "index"}`` for an MLA layer, ``{"conv": {"x", "b",
"c"}, "ssm"}`` for a mamba layer.  Without caches,
under autograd, each layer is rematerialized in the backward
(``cfg.remat == "full"``), the counterpart of ``jax.checkpoint`` on the
reference's scan body (``transformer.py:199-200``).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import attn_fwd, linear, mla_fwd, mlp_fwd, rmsnorm_fwd
from repro_torch.models.moe import moe_fwd
from repro_torch.models.params import layer_params, layer_plan
from repro_torch.models.ssm import ssm_fwd


def _maybe_post(cfg: ArchConfig, p: dict, key: str, x: torch.Tensor) -> torch.Tensor:
    """gemma2's post-sublayer norm on a sublayer's output, before the
    residual add (``repro/models/transformer.py:129-130``)."""
    return rmsnorm_fwd(p[key], x, cfg.norm_eps) if cfg.post_norms else x


def layer_fwd(p: dict, x: torch.Tensor, kind: str, cfg: ArchConfig, *,
              positions: torch.Tensor, cache: dict | None):
    """One layer of kind ``dense``, ``local``, ``global``, ``shared_attn``
    (``p`` is its group's shared set), ``moe``, ``mla_dense``, ``mla_moe``
    or ``mamba``.  Returns (x, new_cache).  The load-balance loss of a
    ``moe`` or ``mla_moe`` layer is dropped: serving does not read it, and
    the port's loss does not train MoE yet (``model.loss_fn``)."""
    rs = cfg.residual_scale
    h = rmsnorm_fwd(p["ln1"], x, cfg.norm_eps)
    if kind == "mamba":
        h, new_cache = ssm_fwd(p["mixer"], h, cfg, cache=cache)
        return x + rs * h, new_cache
    if kind.startswith("mla"):
        h, new_cache = mla_fwd(p["attn"], h, cfg, positions=positions, cache=cache)
    else:
        h, new_cache = attn_fwd(p["attn"], h, cfg, kind=kind, positions=positions,
                                cache=cache)
    x = x + rs * _maybe_post(cfg, p, "post_ln1", h)
    h = rmsnorm_fwd(p["ln2"], x, cfg.norm_eps)
    if kind in ("moe", "mla_moe"):
        b, s, d = h.shape
        h = moe_fwd(p["ffn"], h.reshape(b * s, d), cfg)[0].reshape(b, s, d)
    else:
        h = mlp_fwd(p["ffn"], h, cfg)
    return x + rs * _maybe_post(cfg, p, "post_ln2", h), new_cache


def embed_tokens(params: dict, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    h = params["embed"][tokens] * cfg.embed_scale
    return h.to(torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32)


def unembed(params: dict, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = linear(h.float(), params["embed"].float().t())
    else:
        logits = linear(h.float(), params["lm_head"].float())
    if cfg.final_softcap is not None:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return logits


def forward(params: dict, cfg: ArchConfig, tokens: torch.Tensor, *,
            pos0: "torch.Tensor | int" = 0, caches: list | None = None):
    """Decoder stack. Returns (hidden, new_caches)."""
    h = embed_tokens(params, tokens, cfg)
    steps = torch.arange(tokens.shape[1], device=tokens.device)
    if isinstance(pos0, torch.Tensor) and pos0.dim() >= 1:
        # per-row start positions (B,) -> ragged (B, S) position grid; the
        # attention layers switch to per-row cache writes/masks on seeing it
        positions = pos0[:, None] + steps[None, :]
    else:
        positions = pos0 + steps
    plan = layer_plan(cfg)
    if caches is None:
        remat = torch.is_grad_enabled() and _remat(cfg)
        for kind, where in plan:
            lp = layer_params(params, where)
            if remat:
                h = checkpoint(_cache_free_layer, lp, h, kind, cfg, positions,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                h = _cache_free_layer(lp, h, kind, cfg, positions)
        return rmsnorm_fwd(params["final_norm"], h, cfg.norm_eps), None
    new_caches = []
    for (kind, where), c in zip(plan, caches):
        h, nc = layer_fwd(layer_params(params, where), h, kind, cfg,
                          positions=positions, cache=c)
        new_caches.append(nc)
    h = rmsnorm_fwd(params["final_norm"], h, cfg.norm_eps)
    return h, new_caches


def _cache_free_layer(p: dict, x: torch.Tensor, kind: str, cfg: ArchConfig,
                      positions: torch.Tensor) -> torch.Tensor:
    return layer_fwd(p, x, kind, cfg, positions=positions, cache=None)[0]


def _remat(cfg: ArchConfig) -> bool:
    """Whether to rematerialize each layer in the backward."""
    if cfg.remat == "dots":
        raise NotImplementedError(
            "remat='dots' (save only the matrix products) is not ported yet "
            "(ROADMAP queue 1, \"Training's leftovers\"); use 'full' or 'none'")
    return cfg.remat == "full"
