"""The decoder stack (embedding, a Python loop over the layers, the head)
and an encoder-decoder's encoder stack.

Port of the dense (with gemma2's local/global layers and post-sublayer
norms), mixture-of-experts (``moe``: attention + :mod:`repro_torch.models.
moe`), MLA (deepseek-v3's ``mla_dense`` and ``mla_moe``: Multi-head Latent
Attention + the MLP or the MoE FFN), Mamba-2, hybrid (zamba2's
``shared_attn``) and encoder-decoder (seamless-m4t's ``enc`` and ``dec``:
:func:`encode`, then a decoder whose layers also cross-attend to its
output) paths of ``repro/models/transformer.py``, and the vlm's vision stub
(:func:`forward` with ``patch_embeds``).  The reference scans
each block of stacked layers (``transformer.py:179-222``); the port walks
the layers of
``params.layer_plan``: each layer's kind and where its weights are, its own
dict of ``params["layers"]`` or its group's shared set (every
``shared_attn`` occurrence of a group reads the one set, as the
reference's scan body reads ``shared["shared_attn"]``, ``transformer.py:
182-190``).  Caches are one dict per layer, shared_attn occurrences
included: ``{"k", "v", "index"}`` for an attention layer, the latent
``{"c_kv", "k_rope", "index"}`` for an MLA layer, ``{"conv": {"x", "b",
"c"}, "ssm"}`` for a mamba layer, ``{"self": kv, "cross": kv}`` for a
``dec`` layer (the encoder keeps none).  Without caches,
under autograd, each layer is rematerialized in the backward as
``cfg.remat`` says (:func:`_cache_free_stack`): ``"full"`` recomputes all
of it and ``"dots"`` keeps its matrix products and recomputes the rest,
the counterparts of ``jax.checkpoint`` on the reference's scan body
without and with the policy ``dots_with_no_batch_dims_saveable``
(``transformer.py:199-204``); ``"none"`` keeps everything.  The cache-free
stack also sums the ``moe``/``mla_moe`` layers' load-balance losses, the
training loss's aux term (:func:`forward_with_aux`); serving drops them.

Under an active mesh (``sharding.set_active``: the sharded train step) the
embeddings, the residual stream after every layer and the logits are
pinned to their logical axes (``sharding.constrain_logical``, the
reference's ``transformer.py:226, 237, 276``: there after each scanned
group, here after each layer), and so is the residual between a layer's
attention and its MLP, a pin the reference leaves to GSPMD's propagation
(:func:`layer_fwd`); without a mesh each pin returns its input.
"""

from __future__ import annotations

import functools

import torch
from torch.fx.experimental.proxy_tensor import get_proxy_mode
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro_torch import sharding as shd
from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import attn_fwd, linear, mla_fwd, mlp_fwd, rmsnorm_fwd
from repro_torch.models.moe import moe_fwd
from repro_torch.models.params import encoder_kinds, layer_params, layer_plan
from repro_torch.models.ssm import ssm_fwd


def _maybe_post(cfg: ArchConfig, p: dict, key: str, x: torch.Tensor) -> torch.Tensor:
    """gemma2's post-sublayer norm on a sublayer's output, before the
    residual add (``repro/models/transformer.py:129-130``)."""
    return rmsnorm_fwd(p[key], x, cfg.norm_eps) if cfg.post_norms else x


def layer_fwd(p: dict, x: torch.Tensor, kind: str, cfg: ArchConfig, *,
              positions: torch.Tensor, cache: dict | None,
              enc_out: torch.Tensor | None = None):
    """One layer of kind ``dense``, ``local``, ``global``, ``shared_attn``
    (``p`` is its group's shared set), ``moe``, ``mla_dense``, ``mla_moe``,
    ``mamba``, ``enc`` or ``dec``.  Returns (x, new_cache, aux), as the
    reference's: ``aux`` is the layer's load-balance loss (f32,
    :func:`~repro_torch.models.moe.router_topk`) for a ``moe`` or
    ``mla_moe`` layer and None for any other kind, where the reference's is
    a zero (no op is added where there is no router).  Serving reads no
    aux; the cache-free stack sums it (:func:`forward_with_aux`).

    A ``dec`` layer attends causally to itself over ``cache["self"]``, then
    (after ``ln_cross``) to the encoder: over ``cache["cross"]`` with a
    cache, else to ``enc_out`` (``repro/models/transformer.py:147-161``);
    its new cache is ``{"self", "cross"}``, the cross cache unchanged.  One
    with neither raises ``ValueError``: the reference would cross-attend to
    the decoder's own states there."""
    if kind == "dec" and cache is None and enc_out is None:
        raise ValueError(f"{cfg.name}: a dec layer cross-attends to the encoder; give it a "
                         f"cache filled by prefill or the encoder's output (enc_out)")
    rs = cfg.residual_scale
    h = rmsnorm_fwd(p["ln1"], x, cfg.norm_eps)
    if kind == "mamba":
        h, new_cache = ssm_fwd(p["mixer"], h, cfg, cache=cache)
        return x + rs * h, new_cache, None
    if kind.startswith("mla"):
        h, new_cache = mla_fwd(p["attn"], h, cfg, positions=positions, cache=cache)
    else:
        self_c = cache["self"] if kind == "dec" and cache is not None else cache
        h, new_cache = attn_fwd(p["attn"], h, cfg, kind=kind, positions=positions,
                                cache=self_c)
    # DTensor places each op by its own cost, where GSPMD propagates over
    # the whole step: pinned here too, the residual stays replicated over
    # the model axis, and the MLP's products shard as the reference's do
    x = shd.constrain_logical(x + rs * _maybe_post(cfg, p, "post_ln1", h),
                              ("batch", None, None))
    if kind == "dec":
        hc = rmsnorm_fwd(p["ln_cross"], x, cfg.norm_eps)
        cross_c = cache["cross"] if cache is not None else None
        hc, _ = attn_fwd(p["cross"], hc, cfg, kind="cross", positions=positions,
                         cache=cross_c, x_kv=None if cross_c is not None else enc_out)
        x = x + rs * hc
        if cache is not None:
            new_cache = {"self": new_cache, "cross": cross_c}
    h = rmsnorm_fwd(p["ln2"], x, cfg.norm_eps)
    aux = None
    if kind in ("moe", "mla_moe"):
        b, s, d = h.shape
        h, aux = moe_fwd(p["ffn"], h.reshape(b * s, d), cfg)
        h = h.reshape(b, s, d)
    else:
        h = mlp_fwd(p["ffn"], h, cfg)
    return x + rs * _maybe_post(cfg, p, "post_ln2", h), new_cache, aux


def embed_tokens(params: dict, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    h = params["embed"][tokens] * cfg.embed_scale
    h = h.to(torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32)
    return shd.constrain_logical(h, ("batch", None, None))


def unembed(params: dict, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = linear(h.float(), params["embed"].float().t())
    else:
        logits = linear(h.float(), params["lm_head"].float())
    if cfg.final_softcap is not None:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return shd.constrain_logical(logits, ("batch", None, "vocab"))


def encode(params: dict, cfg: ArchConfig, enc_in: torch.Tensor) -> torch.Tensor:
    """The encoder stack (``repro/models/transformer.py::encode``, :240-250).
    ``enc_in`` is (B, S, frontend_dim) frame embeddings, rounded to bf16 and
    mapped by ``frontend_proj`` (the audio stub), or (B, S) tokens, embedded.
    The encoder layers run cache-free at positions ``arange(S)``, each
    rematerialized in the backward under autograd as in :func:`forward`;
    then ``enc_norm``.  Returns (B, S, d_model)."""
    if enc_in.dim() == 3:
        w = params["frontend_proj"]
        h = linear(enc_in.to(torch.bfloat16).to(w.dtype), w)
    else:
        h = embed_tokens(params, enc_in, cfg)
    positions = torch.arange(h.shape[1], device=h.device)
    h, _ = _cache_free_stack(zip(encoder_kinds(cfg), params["enc_layers"]), h, cfg, positions,
                             None)
    return rmsnorm_fwd(params["enc_norm"], h, cfg.norm_eps)


def forward(params: dict, cfg: ArchConfig, tokens: torch.Tensor, *,
            pos0: "torch.Tensor | int" = 0, caches: list | None = None,
            enc_out: torch.Tensor | None = None,
            patch_embeds: torch.Tensor | None = None):
    """Decoder stack. Returns (hidden, new_caches), new_caches None without
    caches (the cache-free stack's load-balance loss is
    :func:`forward_with_aux`'s).  An encoder-decoder's ``dec`` layers
    cross-attend over their caches or, without caches, to ``enc_out``
    (:func:`encode`'s output).  ``patch_embeds`` (B, npatch,
    frontend_dim), the vision stub's input, replace the embeddings of the
    first npatch token slots (:func:`_with_patches`); the patches take
    positions 0..npatch-1 as tokens would."""
    if caches is None:
        return forward_with_aux(params, cfg, tokens, pos0=pos0, enc_out=enc_out,
                                patch_embeds=patch_embeds)[0], None
    h, positions = _decoder_input(params, cfg, tokens, pos0, patch_embeds)
    new_caches = []
    for (kind, where), c in zip(layer_plan(cfg), caches):
        h, nc, _ = layer_fwd(layer_params(params, where), h, kind, cfg,
                             positions=positions, cache=c, enc_out=enc_out)
        h = shd.constrain_logical(h, ("batch", None, None))
        new_caches.append(nc)
    h = rmsnorm_fwd(params["final_norm"], h, cfg.norm_eps)
    return h, new_caches


def forward_with_aux(params: dict, cfg: ArchConfig, tokens: torch.Tensor, *,
                     pos0: "torch.Tensor | int" = 0, enc_out: torch.Tensor | None = None,
                     patch_embeds: torch.Tensor | None = None):
    """The cache-free decoder stack (:func:`forward` without caches).
    Returns (hidden, aux): ``aux`` is the routers' load-balance loss summed
    over the ``moe``/``mla_moe`` layers, one f32 term a layer in layer
    order (the reference's third output, ``repro/models/transformer.py:
    264-281``), None for a config without experts."""
    h, positions = _decoder_input(params, cfg, tokens, pos0, patch_embeds)
    plan = layer_plan(cfg)
    h, aux = _cache_free_stack(((kind, layer_params(params, where)) for kind, where in plan),
                               h, cfg, positions, enc_out)
    return rmsnorm_fwd(params["final_norm"], h, cfg.norm_eps), aux


def _decoder_input(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                   pos0: "torch.Tensor | int", patch_embeds: torch.Tensor | None):
    """The embeddings (the patches over the leading slots) and positions."""
    h = embed_tokens(params, tokens, cfg)
    if patch_embeds is not None:
        h = _with_patches(params, h, patch_embeds, cfg)
    steps = torch.arange(tokens.shape[1], device=tokens.device)
    if isinstance(pos0, torch.Tensor) and pos0.dim() >= 1:
        # per-row start positions (B,) -> ragged (B, S) position grid; the
        # attention layers switch to per-row cache writes/masks on seeing it
        return h, pos0[:, None] + steps[None, :]
    return h, pos0 + steps


def _with_patches(params: dict, h: torch.Tensor, patch_embeds: torch.Tensor,
                  cfg: ArchConfig) -> torch.Tensor:
    """The vision stub (``repro/models/transformer.py:259-262``): the
    patches, cast to ``h``'s dtype, mapped by ``frontend_proj`` in one
    ``mm``, then put in place of the first npatch rows of ``h``.  A prompt
    shorter than its patches raises ``ValueError`` (the reference's
    concatenate would give npatch rows against S positions)."""
    npatch, s = patch_embeds.shape[1], h.shape[1]
    if npatch > s:
        raise ValueError(f"{cfg.name}: {npatch} patches do not fit a prompt of {s} tokens; "
                         f"the patches replace the prompt's first {npatch} token slots")
    pe = linear(patch_embeds.to(h.dtype), params["frontend_proj"])
    return torch.cat([pe, h[:, npatch:]], 1)


def _cache_free_stack(layers, h: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
                      enc_out: torch.Tensor | None):
    """``layers`` ((kind, params), ...) run cache-free in order.  Returns
    (h, aux): ``aux`` sums the layers' load-balance losses in f32, one term
    a layer in layer order, or is None where no layer has a router.  Under
    autograd each layer is one checkpoint returning (h, its aux), so the
    recompute gives aux its gradient (``cfg.remat`` ``"full"`` or
    ``"dots"``; ``"none"`` saves what autograd saves): the reference
    checkpoints each scanned unit instead (gemma2's is two layers), which
    recomputes the same ops from the same inputs, so the numbers are the
    same.  While a tracer records the step (``Overlay.jit``), ``"dots"``
    checkpoints as ``"full"`` does: under a tracer's proxy mode torch's
    selective checkpoint would save every op's output (it leaves the choice
    to a compiler's partitioner), the memory of ``"none"``; ``"full"``
    gives the same numbers and recomputes every layer."""
    remat = cfg.remat in ("full", "dots") and torch.is_grad_enabled()
    dots = cfg.remat == "dots" and get_proxy_mode() is None
    extra = {"context_fn": _SAVE_PRODUCTS} if dots else {}
    total = None
    for kind, lp in layers:
        if remat:
            h, aux = checkpoint(_cache_free_layer, lp, h, kind, cfg, positions, enc_out,
                                use_reentrant=False, preserve_rng_state=False, **extra)
        else:
            h, aux = _cache_free_layer(lp, h, kind, cfg, positions, enc_out)
        h = shd.constrain_logical(h, ("batch", None, None))
        if aux is not None:
            total = aux if total is None else total + aux
    return h, total


# The "dots" policy, the counterpart of the reference's
# ``dots_with_no_batch_dims_saveable``: every 2-D product of the model is one
# ``aten.mm`` (``layers.linear``), saved in the forward; every other op —
# ``bmm`` (batched), the attention and rmsnorm ops, elementwise — is
# recomputed in the backward, as the reference recomputes its Pallas calls.
_SAVE_PRODUCTS = functools.partial(create_selective_checkpoint_contexts,
                                   [torch.ops.aten.mm.default])


def _cache_free_layer(p: dict, x: torch.Tensor, kind: str, cfg: ArchConfig,
                      positions: torch.Tensor, enc_out: torch.Tensor | None):
    x, _, aux = layer_fwd(p, x, kind, cfg, positions=positions, cache=None, enc_out=enc_out)
    return x, aux
