"""Top-level model API: the training loss, KV-cache allocation, prefill,
decode, and the model step as an overlay graph.

Port of ``repro/models/model.py`` (``cross_entropy`` :25, ``loss_fn`` :51,
``init_cache`` :92 (and ``layer_cache_spec`` and ``cache_spec``,
``repro/models/transformer.py:97-123``),
``prefill`` :96, ``decode_step`` :150,
``prefill_chunk`` :164, ``_current_index`` :185, ``build_step_graph``
:203, ``_fill_cross_caches`` :114) for decoder LMs of dense (full or
sliding-window), mamba, shared-attention (zamba2), mixture-of-experts
(granite; its loss adds the routers' load-balance loss) and MLA
(deepseek-v3's ``mla_dense``/``mla_moe``; its loss adds the
multi-token-prediction term, which runs the ``mtp`` module) layers, for
the encoder-decoder seamless-m4t (served through :func:`prefill` with
``enc_in`` and :func:`decode_step`; its loss runs the encoder on the
batch's frames, then the decoder cross-attending to the encoder's output)
and for the vlm pixtral (its patch embeddings through :func:`prefill` with
``patch_embeds``, its decodes as a text model's; its loss masks the patch
positions out of the cross-entropy).
"""

from __future__ import annotations

import torch

from repro_torch import sharding as shd
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import params as pm
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import attn_cache_spec, cache_update, linear, mla_cache_spec
from repro_torch.models.params import layer_kinds
from repro_torch.models.ssm import ssm_cache_spec
from repro_torch.sharding import is_dtensor


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None):
    """Mean next-token CE in f32 + accuracy. logits: (B,S,V), labels: (B,S).

    The reference extracts the gold logit as ``sum(logits * one_hot)`` to
    keep a model-sharded vocab axis local; so does the port on DTensor
    logits (the sharded step).  On one device a gather picks the same
    element (the one-hot sum only adds exact zeros to it), so both give
    the same value."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    if is_dtensor(logits):
        vocab = torch.arange(logits.shape[-1], device=labels.device)
        gold = torch.sum(logits * (labels.long()[..., None] == vocab), dim=-1)
    else:
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    mask = torch.ones_like(nll) if mask is None else mask.float()
    denom = torch.clamp(torch.sum(mask), min=1.0)
    loss = torch.sum(nll * mask) / denom
    # argmax over a sharded vocab has no working DTensor rule on every mesh:
    # gather the vocab first (a no-op without an active mesh)
    whole = shd.constrain_logical(logits, ("batch", None, None))
    acc = torch.sum((torch.argmax(whole, -1) == labels) * mask) / denom
    return loss, acc


def loss_fn(params: dict, batch: dict, cfg: ArchConfig, *, aux_weight: float = 0.01):
    """Returns (loss, metrics) for every family: ``ce + aux_weight * aux``
    and ``{"ce", "acc", "aux"}`` (``repro/models/model.py:49-86``), ``aux``
    the routers' load-balance loss summed over the layers
    (:func:`~repro_torch.models.transformer.forward_with_aux`; 0 for a
    config without experts).  batch: ``tokens`` and ``labels`` (tokens
    shifted by the caller), optional ``mask``; a vlm's ``patch_embeds``
    (B, npatch, frontend_dim) go through the vision stub over the first
    npatch slots, and without a ``mask`` of the batch's own those slots
    leave the loss (``pos >= npatch``, :63-69): a caller's ``mask`` wins,
    as in the reference.  A config with ``mtp_depth`` (deepseek-v3) adds
    ``0.3 * ce2``, the multi-token-prediction term (:func:`_mtp_ce`,
    :73-85); the metrics keep their three keys.  An encoder-decoder
    (seamless-m4t) first runs the encoder on the batch's ``frames`` (B, Sk,
    frontend_dim) (:func:`~repro_torch.models.transformer.encode`, its
    layers rematerialized as the decoder's), and every ``dec`` layer
    cross-attends to the encoder's output (:56-60); Sk need not be the
    tokens' S."""
    enc_out = tfm.encode(params, cfg, batch["frames"]) if cfg.is_encdec else None
    patches = batch.get("patch_embeds")
    h, aux = tfm.forward_with_aux(params, cfg, batch["tokens"], enc_out=enc_out,
                                  patch_embeds=patches)
    logits = tfm.unembed(params, h, cfg)
    mask = batch.get("mask")
    if mask is None and patches is not None:
        pos = torch.arange(batch["tokens"].shape[1], device=batch["tokens"].device)[None]
        mask = (pos >= patches.shape[1]).float() * torch.ones_like(batch["labels"],
                                                                    dtype=torch.float32)
    ce, acc = cross_entropy(logits, batch["labels"], mask)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=ce.device)
    loss = ce + aux_weight * aux
    if cfg.mtp_depth:
        loss = loss + 0.3 * _mtp_ce(params, h, batch["labels"], cfg)
    return loss, {"ce": ce, "acc": acc, "aux": aux}


def _mtp_ce(params: dict, h: torch.Tensor, labels: torch.Tensor, cfg: ArchConfig):
    """deepseek-v3's multi-token prediction at depth 1
    (``repro/models/model.py:73-85``): position t sees ``[h_t ; emb(label_t)]``
    (``h`` the decoder's output after the final norm), mapped by
    ``mtp.proj`` in one ``mm``, through one ``dense`` layer at positions
    0..S-2 (outside the rematerialized stack, as in the reference; its aux
    is None), ``mtp.norm`` and the unembedding, and predicts ``label_{t+1}``.
    Returns that cross-entropy, ``ce2``, over every position: it takes no
    mask, not even the batch's own."""
    mtp = params["mtp"]
    lbl_emb = tfm.embed_tokens(params, labels, cfg)
    h_in = linear(torch.cat([h[:, :-1], lbl_emb[:, :-1]], -1).to(lbl_emb.dtype), mtp["proj"])
    positions = torch.arange(h_in.shape[1], device=h_in.device)
    h2 = tfm.layer_fwd(mtp["layer"], h_in, "dense", cfg, positions=positions, cache=None)[0]
    h2 = tfm.rmsnorm_fwd(mtp["norm"], h2, cfg.norm_eps)
    ce2, _ = cross_entropy(tfm.unembed(params, h2, cfg), labels[:, 1:], None)
    return ce2


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------
def layer_cache_spec(cfg: ArchConfig, kind: str, batch: int, max_len: int) -> dict:
    """One layer's cache as specs with logical axes
    (``repro/models/transformer.py::layer_cache_spec``, :97-113): the conv
    windows and SSD state of a mamba layer
    (:func:`~repro_torch.models.ssm.ssm_cache_spec`), the latent cache of
    an MLA layer (:func:`~repro_torch.models.layers.mla_cache_spec`), two
    KV caches ``{"self", "cross"}`` of max_len for a ``dec`` layer (the
    cross one's head dim carries no axis, as in the reference), and a bf16
    KV cache (:func:`~repro_torch.models.layers.attn_cache_spec`) for
    every other kind."""
    if kind == "mamba":
        return ssm_cache_spec(cfg, batch)
    if kind.startswith("mla"):
        return mla_cache_spec(cfg, batch, max_len)
    if kind == "dec":
        shape = (batch, cfg.num_kv_heads, max_len, cfg.resolved_head_dim)
        axes = ("batch", "kv_heads", "seq", None)
        cross = {"k": pm.ParamSpec(shape, axes, "zeros", dtype=torch.bfloat16),
                 "v": pm.ParamSpec(shape, axes, "zeros", dtype=torch.bfloat16),
                 "index": pm.ParamSpec((), (), "zeros", dtype=torch.int32)}
        return {"self": attn_cache_spec(cfg, batch, max_len), "cross": cross}
    return attn_cache_spec(cfg, batch, max_len)


def cache_param_spec(cfg: ArchConfig, batch: int, max_len: int) -> list[dict]:
    """The caches as specs, one dict a layer in execution order (every
    ``shared_attn`` occurrence gets a cache of its own, though all of them
    read one weight set: the reference's ``cache_spec``,
    ``repro/models/transformer.py:115-123``, whose stacked tree holds the
    same leaves per layer)."""
    return [layer_cache_spec(cfg, kind, batch, max_len) for kind in layer_kinds(cfg)]


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device: "str | torch.device | None" = None) -> list[dict]:
    """Zeroed caches of :func:`cache_param_spec` on ``device`` (default
    ``cuda``): a bf16 KV cache whatever the parameter dtype, as the
    reference's.  A ``dec`` layer's cross cache is max_len long: the
    encoder's output must fit it too."""
    return pm.zeros(cache_param_spec(cfg, batch, max_len), device)


def cache_spec(cfg: ArchConfig, batch: int, max_len: int,
               device: "str | torch.device | None" = None) -> list[dict]:
    """:func:`init_cache`'s caches as :class:`~repro_torch.core.graph.
    TensorSpec` on ``device`` (default ``cuda``), allocating nothing."""
    return pm.abstract(cache_param_spec(cfg, batch, max_len), device)


def prefill(params: dict, cfg: ArchConfig, tokens: torch.Tensor, caches: list, *,
            enc_in: torch.Tensor | None = None,
            patch_embeds: torch.Tensor | None = None):
    """Run the prompt through the decoder, filling caches.
    Returns (logits_last (B, V), caches).

    A vlm's ``patch_embeds`` (B, npatch, frontend_dim) replace the prompt's
    first npatch token slots (:func:`~repro_torch.models.transformer.
    forward`); the cache then holds S positions, patches included, and
    :func:`decode_step` goes on at S.  Only prefill takes patches, as in
    the reference (``repro/models/model.py:96-111``).

    An encoder-decoder first runs the encoder on ``enc_in`` (frames (B, S,
    frontend_dim) or tokens (B, S), :func:`~repro_torch.models.
    transformer.encode`) and fills every ``dec`` layer's cross cache from
    its output (:func:`_fill_cross_caches`); one without ``enc_in`` raises
    ``ValueError`` (the reference fails there on ``None.ndim``)."""
    enc_out = None
    if cfg.is_encdec:
        if enc_in is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: prefill needs the "
                             f"encoder's input (enc_in)")
        enc_out = tfm.encode(params, cfg, enc_in)
        caches = _fill_cross_caches(params, cfg, enc_out, caches)
    h, caches = tfm.forward(params, cfg, tokens, pos0=0, caches=caches, enc_out=enc_out,
                            patch_embeds=patch_embeds)
    return tfm.unembed(params, h[:, -1:], cfg)[:, 0], caches


def _fill_cross_caches(params: dict, cfg: ArchConfig, enc_out: torch.Tensor,
                       caches: list) -> list:
    """Every ``dec`` layer's cross-attention keys and values, computed once
    from the encoder's output (``repro/models/model.py:114-147``): ``enc_out
    @ wk`` and ``@ wv``, head-split, written at positions 0..S-1 of a zeroed
    cache (the functional :func:`~repro_torch.models.layers.cache_update`,
    so a traced prefill is the eager one), the index set to S.  Returns the
    new cache list; the other layers' caches are passed through."""
    b, s, _ = enc_out.shape
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    new = []
    for (kind, where), c in zip(pm.layer_plan(cfg), caches):
        if kind != "dec":
            new.append(c)
            continue
        smax = c["cross"]["k"].shape[2]
        if s > smax:
            raise ValueError(f"{cfg.name}: the encoder's output has {s} positions, more than "
                             f"the cross cache's max_len {smax}")
        w = pm.layer_params(params, where)["cross"]
        cross = {}
        for name in ("k", "v"):
            t = linear(enc_out, w[f"w{name}"]).reshape(b, s, hkv, hd).transpose(1, 2)
            cross[name] = cache_update(torch.zeros_like(c["cross"][name]), t, 0, axis=2)
        cross["index"] = torch.full_like(c["cross"]["index"], s)
        new.append({"self": c["self"], "cross": cross})
    return new


def decode_step(params: dict, cfg: ArchConfig, token: torch.Tensor,
                caches: list, *, positions: torch.Tensor | None = None):
    """One token for every sequence in the batch. token: (B, 1).

    ``positions=None`` reads the shared scalar cache index (uniform batch).
    Pass a (B,) int tensor to decode each row at its OWN KV position
    (ragged continuous batching)."""
    pos0 = _current_index(cfg, caches) if positions is None else positions
    h, caches = tfm.forward(params, cfg, token, pos0=pos0, caches=caches)
    return tfm.unembed(params, h, cfg)[:, 0], caches


def prefill_chunk(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                  caches: list, last_index: torch.Tensor):
    """Prefill ONE fixed-size chunk of a prompt into ``caches``.

    ``tokens``: (B, C) — the next C prompt tokens, starting at the cache's
    current index.  The final chunk of a prompt may be right-padded to a
    power-of-two bucket; padded positions write garbage K/V beyond the real
    prompt, which is causally masked here and overwritten position by
    position by decode before any query can attend to it.  (A mamba layer
    has no such mask: the padded tokens advance its conv and SSD state,
    which is why the event-loop engine refuses mamba configs.)
    ``last_index`` is a 0-d int tensor selecting the in-chunk position
    whose logits are returned — the chunk length C is the only static
    shape, so one traced signature serves every prompt sharing a bucket.
    The reference unembeds the whole chunk and then selects; the port
    selects the hidden row first and unembeds that one row, the same
    values per row, as :func:`prefill` does with the last one.
    Returns (logits (B, V), caches)."""
    pos0 = _current_index(cfg, caches)
    h, caches = tfm.forward(params, cfg, tokens, pos0=pos0, caches=caches)
    sel = torch.index_select(h, 1, last_index.reshape(1).to(torch.int64))
    return tfm.unembed(params, sel, cfg)[:, 0], caches


def _current_index(cfg: ArchConfig, caches: list) -> torch.Tensor:
    """The shared decode position: the first attention layer's cache index
    (mamba layers keep none; a pure-SSM model has no position, so 0).  In
    zamba2 that is layer 8, the first ``shared_attn`` occurrence; an MLA
    layer's latent cache keeps its index as a KV cache does; a ``dec``
    layer's is its self cache's."""
    for kind, c in zip(layer_kinds(cfg), caches):
        if kind == "dec":
            return c["self"]["index"]
        if kind != "mamba":
            return c["index"]
    return torch.zeros((), dtype=torch.int32, device=caches[0]["ssm"].device)


# ---------------------------------------------------------------------------
# Overlay integration: the model step as an assembled DFG
# ---------------------------------------------------------------------------
def build_step_graph(cfg: ArchConfig, batch_shape: tuple[int, int],
                     device: "str | torch.device | None" = None):
    """The model's cache-free forward as a :class:`~repro_torch.core.graph.
    Graph` of LARGE stage operators: embed -> g0 -> g1 ... -> head, each
    taking (params, x).  The params input node fans out to every stage (the
    controller's LD_CONST of per-tile configuration).  Stage ``g<i>`` runs
    the layers of ``cfg.blocks[i]``; the head is the final norm and the
    unembedding, so the graph's output is the logits (B, S, V) of
    :func:`~repro_torch.models.transformer.forward` + ``unembed``.  The
    avals of the inputs live on ``device`` (default ``cuda``).

    An encoder-decoder is refused: the reference's stages carry no
    encoder output (``repro/models/model.py:227-230``), so its ``dec``
    layers would cross-attend to the decoder's own states
    (``repro/models/layers.py:272-279``)."""
    from repro_torch.core.graph import Graph
    from repro_torch.core.patterns import Operator, TileClass

    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the step graph's stages carry no encoder output, so an "
            f"encoder-decoder's dec layers would cross-attend to the decoder's own "
            f"states (the reference's build_step_graph does so); serve it through "
            f"prefill(enc_in=) and decode_step")
    dev = resolve_device(device)
    b, s = batch_shape
    abstract_params = pm.abstract(pm.model_spec(cfg), dev)
    plan = pm.layer_plan(cfg)

    g = Graph(f"{cfg.name}.fwd")
    p_in = g.input_tree("params", abstract_params)
    tok = g.input("tokens", (b, s), torch.int32, dev)

    embed_op = Operator(f"{cfg.name}/embed", 2,
                        lambda p, t: tfm.embed_tokens(p, t, cfg), TileClass.LARGE)
    h = g.apply(embed_op, p_in, tok)

    first = 0
    for gi, (unit, rep) in enumerate(cfg.blocks):
        span = range(first, first + len(unit) * rep)
        first = span.stop

        def stage_fn(p, x, _span=span):
            positions = torch.arange(x.shape[1], device=x.device)
            for li in _span:
                kind, where = plan[li]
                x = tfm.layer_fwd(pm.layer_params(p, where), x, kind, cfg,
                                  positions=positions, cache=None)[0]
            return x

        op = Operator(f"{cfg.name}/g{gi}", 2, stage_fn, TileClass.LARGE)
        h = g.apply(op, p_in, h)

    head_op = Operator(
        f"{cfg.name}/head", 2,
        lambda p, x: tfm.unembed(p, tfm.rmsnorm_fwd(p["final_norm"], x, cfg.norm_eps), cfg),
        TileClass.LARGE)
    g.output(g.apply(head_op, p_in, h))
    return g
