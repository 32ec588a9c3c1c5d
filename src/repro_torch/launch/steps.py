"""Step functions and abstract input specs for every (arch x shape) cell, on
one device.

Port of the single-device half of ``repro/launch/steps.py`` (:1-101).  The
four shapes:
  train_4k     seq 4096,   global_batch 256  -> train_step
  prefill_32k  seq 32768,  global_batch 32   -> prefill (serve)
  decode_32k   seq 32768,  global_batch 128  -> serve_step (1 new token, full cache)
  long_500k    seq 524288, global_batch 1    -> serve_step (SSM/hybrid only)

:func:`input_specs` and :func:`train_state_specs` return
:class:`~repro_torch.core.graph.TensorSpec` stand-ins (shape, dtype,
device; nothing is allocated) on ``device``, ``cuda`` unless the caller
asks for another.  The caches are the port's: one dict per layer
(:func:`~repro_torch.models.model.cache_spec`), where the reference stacks
each block's layers.  :func:`applicable` encodes the skip rule.  The
``make_*_step`` functions return plain functions of tensors: the train
step is functional (``launch.train.make_step`` is the in-place form the
launcher runs).

The shardings (``repro/launch/steps.py:104-155``): :func:`batch_shardings`
and :func:`cell_shardings` give each input and output of a cell's step its
:class:`~repro_torch.sharding.NamedSharding` from the specs' logical axes.
The reference's sharded step is its ``train_step`` under ``jax.jit`` with
those shardings (GSPMD); the port's is the same :func:`make_train_step`
run on DTensors (``torch.distributed.tensor``):
:func:`shard_train_state` and :func:`shard_batch` distribute the state and
the batch, and :func:`make_sharded_train_step` runs the step under the
active mesh (the model's ``constrain_logical`` sites then place its
activations) and puts the new state back on the input shardings, as the
reference's ``out_shardings`` do.  The sharded serve steps
(:func:`make_sharded_prefill_step`, :func:`make_sharded_serve_step`, on
the state of :func:`shard_serve_state`) are the reference's prefill and
decode under ``jax.jit`` with a cell's shardings, as its dry run lowers
them (``repro/launch/dryrun.py:181-273``).  They cover the dense family
(layers ``dense``, ``local``, ``global``); the other families are refused
by name (ROADMAP queue 1 item 4).
"""

from __future__ import annotations

import contextlib
from typing import Any

import torch
from torch.utils import _pytree as pytree

from repro_torch import sharding as shd
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import _npatch, batch_specs
from repro_torch.device import resolve_device
from repro_torch.launch.train import _loss_and_grads
from repro_torch.models import model as mdl
from repro_torch.models import params as pm
from repro_torch.optim import adamw_update, decay_mask, opt_state_spec

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}


def applicable(cfg: ArchConfig, shape: str) -> tuple[bool, str]:
    """(runnable?, reason): a 500k-token decode only where the decoder has a
    mamba layer (``cfg.subquadratic``)."""
    if shape == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch — 500k decode needs sub-quadratic mixing"
    return True, ""


# ---------------------------------------------------------------------------
# Abstract inputs
# ---------------------------------------------------------------------------
def input_specs(cfg: ArchConfig, shape: str,
                device: "str | torch.device | None" = None) -> dict:
    """The step's inputs for a cell: a train batch (``batch_specs``); a
    prefill's tokens, caches of ``seq`` and ``extras`` (a vlm's bf16
    ``patch_embeds``, min(256, seq // 2) of them; an encoder-decoder's bf16
    frames ``enc_in``, ``seq`` of them); a decode's one token against
    caches of ``seq``."""
    from repro_torch.core.graph import TensorSpec
    dev = resolve_device(device)
    info = SHAPES[shape]
    seq, batch, kind = info["seq"], info["batch"], info["kind"]
    if kind == "train":
        return {"batch": batch_specs(cfg, batch, seq, dev)}
    caches = mdl.cache_spec(cfg, batch, seq, dev)
    if kind == "decode":
        return {"tokens": TensorSpec((batch, 1), torch.int32, dev), "caches": caches}
    return {"tokens": TensorSpec((batch, seq), torch.int32, dev), "caches": caches,
            "extras": _extras_specs(cfg, batch, seq, dev)}


def _extras_specs(cfg: ArchConfig, batch: int, seq: int, device="meta") -> dict:
    from repro_torch.core.graph import TensorSpec
    extras = {}
    if cfg.frontend == "vision":
        extras["patch_embeds"] = TensorSpec((batch, _npatch(seq), cfg.frontend_dim),
                                            torch.bfloat16, device)
    if cfg.is_encdec:
        extras["enc_in"] = TensorSpec((batch, seq, cfg.frontend_dim), torch.bfloat16, device)
    return extras


def train_state_specs(cfg: ArchConfig,
                      device: "str | torch.device | None" = None) -> tuple[Any, Any]:
    """(parameters, optimizer state) as specs: the model's leaves and AdamW's
    int32 step and f32 moments."""
    spec = pm.model_spec(cfg)
    return pm.abstract(spec, device), pm.abstract(opt_state_spec(spec), device)


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------
def make_train_step(cfg: ArchConfig, *, lr: float = 3e-4):
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``: the
    loss and its gradients, then a functional AdamW step at ``lr``; the
    metrics are the reference's, ``{"loss", "ce", "acc", "aux",
    "grad_norm"}``."""
    def train_step(params, opt_state, batch):
        loss, metrics, grads, spec = _loss_and_grads(cfg, params, batch)
        params, opt_state, om = adamw_update(params, pytree.tree_unflatten(grads, spec),
                                             opt_state, lr=lr, decay=decay_mask(params))
        return params, opt_state, {"loss": loss, **metrics, **om}
    return train_step


def make_prefill_step(cfg: ArchConfig):
    """``(params, tokens, caches, extras) -> (logits (B, V), caches)``:
    :func:`~repro_torch.models.model.prefill` with the extras' ``enc_in``
    and ``patch_embeds``."""
    def prefill_step(params, tokens, caches, extras):
        return mdl.prefill(params, cfg, tokens, caches, enc_in=extras.get("enc_in"),
                           patch_embeds=extras.get("patch_embeds"))
    return prefill_step


def make_serve_step(cfg: ArchConfig):
    """``(params, tokens, caches) -> (logits (B, V), caches)``: one decode."""
    def serve_step(params, tokens, caches):
        return mdl.decode_step(params, cfg, tokens, caches)
    return serve_step


# ---------------------------------------------------------------------------
# Shardings
# ---------------------------------------------------------------------------
def _spec_tree_shardings(mesh, rules, spec_tree):
    """NamedShardings for a ParamSpec tree (shape-aware divisibility)."""
    return pytree.tree_map(lambda s: shd.named_sharding(mesh, rules, s.axes, s.shape),
                           spec_tree, is_leaf=pm.is_spec)


def _sds_shardings(mesh, rules, tree, axes_fn):
    return pytree.tree_map(
        lambda s: shd.named_sharding(mesh, rules, axes_fn(s), tuple(s.shape)), tree)


def batch_shardings(mesh, rules, batch_spec_tree):
    """Every leaf of a batch (specs or tensors) sharded on its leading batch
    dim: (B, S) tokens and labels, (B, P, F) patches, (B, S, F) frames."""
    return _sds_shardings(mesh, rules, batch_spec_tree,
                          lambda s: ("batch",) + (None,) * (len(s.shape) - 1))


def cell_shardings(cfg: ArchConfig, shape: str, mesh,
                   rules: shd.ShardingRules | None = None):
    """(in_shardings, out_shardings) of a cell's step function, as the
    reference's: ``(params, opt_state, batch)`` -> ``(params, opt_state,
    None)`` for a train cell (the metrics replicated);
    ``(params, tokens, caches, extras)`` -> ``(logits, caches)`` for a
    prefill; ``(params, tokens, caches)`` -> ``(logits, caches)`` for a
    decode.  The caches are the port's, one dict a layer
    (:func:`~repro_torch.models.model.cache_param_spec`)."""
    rules = rules or shd.DEFAULT_RULES
    info = SHAPES[shape]
    if info["kind"] != "train":
        return serve_shardings(cfg, info["kind"], info["batch"], info["seq"], mesh, rules)
    spec = pm.model_spec(cfg)
    p_sh = _spec_tree_shardings(mesh, rules, spec)
    opt_sh = _spec_tree_shardings(mesh, rules, opt_state_spec(spec))
    b_sh = batch_shardings(mesh, rules, input_specs(cfg, shape, "meta")["batch"])
    return (p_sh, opt_sh, b_sh), (p_sh, opt_sh, None)


def serve_shardings(cfg: ArchConfig, kind: str, batch: int, max_len: int, mesh,
                    rules: shd.ShardingRules | None = None, seq: int | None = None):
    """:func:`cell_shardings` of a ``"prefill"`` or ``"decode"`` step at
    any batch and cache length (``seq`` prompt tokens, ``max_len`` unless
    given; a decode's one): a cell's are these at its own shape, and a
    smaller state is placed by the same logical axes with its own
    divisibility."""
    rules = rules or shd.DEFAULT_RULES
    p_sh = _spec_tree_shardings(mesh, rules, pm.model_spec(cfg))
    cache_sh = _spec_tree_shardings(mesh, rules, mdl.cache_param_spec(cfg, batch, max_len))
    toks = (batch, 1 if kind == "decode" else seq or max_len)
    tok_sh = shd.named_sharding(mesh, rules, ("batch", None), toks)
    logits_sh = shd.named_sharding(mesh, rules, ("batch", None), (batch, cfg.vocab_size))
    if kind == "prefill":
        extras = {k: shd.named_sharding(mesh, rules, ("batch",) + (None,) * (len(v.shape) - 1),
                                        tuple(v.shape))
                  for k, v in _extras_specs(cfg, batch, toks[1]).items()}
        return (p_sh, tok_sh, cache_sh, extras), (logits_sh, cache_sh)
    return (p_sh, tok_sh, cache_sh), (logits_sh, cache_sh)


# ---------------------------------------------------------------------------
# The sharded train step (DTensor)
# ---------------------------------------------------------------------------
SHARDED_KINDS = ("dense", "local", "global")


def check_sharded_family(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a config outside the dense family,
    naming what its sharded steps still need: no sharded step runs a model
    unsharded in silence."""
    kinds = set(pm.layer_kinds(cfg)) | set(pm.encoder_kinds(cfg))
    needs = []
    if kinds & {"moe", "mla_moe"}:
        needs.append("MoE (expert parallelism inside a DTensor step)")
    if any(k.startswith("mla") for k in kinds):
        needs.append("MLA")
    if kinds & {"mamba", "shared_attn"}:
        needs.append("mamba/hybrid (a DTensor strategy for repro_torch::ssd)")
    if cfg.is_encdec:
        needs.append("the encoder-decoder")
    if cfg.frontend == "vision":
        needs.append("the vlm")
    if needs or not kinds <= set(SHARDED_KINDS) or cfg.mtp_depth:
        raise NotImplementedError(
            f"{cfg.name}: the sharded steps (train, prefill, decode) cover the dense family "
            f"(layers {list(SHARDED_KINDS)}); {', '.join(needs) or sorted(kinds)} is a later "
            f"slice of ROADMAP queue 1 item 4 (multi-device)")


def _distribute(tree, shardings):
    """Each tensor of ``tree`` as a DTensor at its NamedSharding; a DTensor
    already on the sharding's mesh is redistributed (only if it must be),
    one on another mesh is gathered whole and distributed anew."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def place(t, sh):
        want = sh.placements()
        if isinstance(t, DTensor):
            if t.device_mesh == sh.mesh:
                return t if tuple(t.placements) == want else t.redistribute(sh.mesh, want)
            t = t.full_tensor()
        return distribute_tensor(t.detach(), sh.mesh, want)

    return pytree.tree_map(place, tree, shardings)


def shard_train_state(cfg: ArchConfig, params, opt_state, mesh,
                      rules: shd.ShardingRules | None = None):
    """``(params, opt_state)`` as DTensors on ``mesh``, placed by
    :func:`cell_shardings` (the train cell's: each parameter by its logical
    axes and shape, each moment as its parameter, the step replicated).
    The tensors must lie on the mesh's device type; a state already on
    another mesh is moved to this one."""
    (p_sh, opt_sh, _), _ = cell_shardings(cfg, "train_4k", mesh, rules)
    return _distribute(params, p_sh), _distribute(opt_state, opt_sh)


def shard_batch(batch: dict, mesh, rules: shd.ShardingRules | None = None) -> dict:
    """A batch as DTensors by :func:`batch_shardings` of its own shapes."""
    return _distribute(batch, batch_shardings(mesh, rules or shd.DEFAULT_RULES, batch))


@contextlib.contextmanager
def on_mesh(mesh, rules: shd.ShardingRules | None = None):
    """Run model code on DTensors: ``(mesh, rules)`` active, so the model
    pins its activations (``sharding.constrain_logical``), and DTensor's
    implicit replication on, so the plain tensors the model makes
    (positions, masks) act as replicated.  The active mesh before is put
    back after."""
    from torch.distributed.tensor.experimental import implicit_replication

    before = shd.active()
    shd.set_active(mesh, rules or shd.DEFAULT_RULES)
    try:
        with implicit_replication():
            yield
    finally:
        shd.set_active(*(before or (None,)))


def make_sharded_train_step(cfg: ArchConfig, mesh, rules: shd.ShardingRules | None = None,
                            *, lr: float = 3e-4):
    """:func:`make_train_step` on a ``DeviceMesh``: ``(params, opt_state,
    batch) -> (params, opt_state, metrics)`` on the DTensor state of
    :func:`shard_train_state`.  A batch of plain tensors is distributed by
    :func:`shard_batch`.  The step runs :func:`on_mesh`.  The new
    parameters and moments come back on the input shardings; the metrics
    are replicated DTensors.  Only the dense family
    (:func:`check_sharded_family`)."""
    check_sharded_family(cfg)
    rules = rules or shd.DEFAULT_RULES
    step = make_train_step(cfg, lr=lr)
    (p_sh, opt_sh, _), _ = cell_shardings(cfg, "train_4k", mesh, rules)

    def sharded_train_step(params, opt_state, batch):
        with on_mesh(mesh, rules):
            params, opt_state, metrics = step(params, opt_state,
                                              shard_batch(batch, mesh, rules))
        replicated = [shd.NamedSharding(mesh, shd.PartitionSpec())] * len(metrics)
        metrics = dict(zip(metrics, _distribute(list(metrics.values()), replicated)))
        return _distribute(params, p_sh), _distribute(opt_state, opt_sh), metrics

    return sharded_train_step


# ---------------------------------------------------------------------------
# The sharded serve steps (DTensor)
# ---------------------------------------------------------------------------
def _cache_shape(caches) -> tuple[int, int]:
    """(batch, max_len) of the caches (a KV cache's ``k`` is (B, Hkv, Smax, hd))."""
    batch, _, max_len, _ = caches[0]["k"].shape
    return batch, max_len


def shard_serve_state(cfg: ArchConfig, params, caches, mesh,
                      rules: shd.ShardingRules | None = None):
    """``(params, caches)`` as DTensors on ``mesh`` at the placements of
    :func:`serve_shardings` at the caches' own batch and length (a prefill
    cell's and a decode cell's are the same): no FSDP under
    ``SERVE_RULES`` or ``NO_FSDP_RULES``, each cache's ``seq`` dim over
    ``model`` under ``SERVE_RULES`` where its kv heads do not take that
    axis, the index a replicated int32 scalar."""
    check_sharded_family(cfg)
    (p_sh, _, c_sh), _ = serve_shardings(cfg, "decode", *_cache_shape(caches), mesh,
                                         rules or shd.DEFAULT_RULES)
    return _distribute(params, p_sh), _distribute(caches, c_sh)


def _sharded_serve(cfg, kind, step, mesh, rules):
    check_sharded_family(cfg)
    rules = rules or shd.DEFAULT_RULES
    memo = {}   # (batch, max_len, tokens) -> serve_shardings, computed once each

    def run(params, tokens, caches, *extras):
        key = (*_cache_shape(caches), tokens.shape[1])
        if key not in memo:
            memo[key] = serve_shardings(cfg, kind, *key[:2], mesh, rules, key[2])
        (p_sh, tok_sh, c_sh, *_), (logits_sh, _) = memo[key]
        params, caches = _distribute(params, p_sh), _distribute(caches, c_sh)
        with on_mesh(mesh, rules):
            logits, caches = step(params, _distribute(tokens, tok_sh), caches, *extras)
        return _distribute(logits, logits_sh), _distribute(caches, c_sh)

    return run


def make_sharded_prefill_step(cfg: ArchConfig, mesh, rules: shd.ShardingRules | None = None):
    """:func:`make_prefill_step` on a ``DeviceMesh``: ``(params, tokens,
    caches, extras={}) -> (logits, caches)`` under :func:`on_mesh`, the
    tokens placed as ``("batch", None)``, the parameters and caches as
    :func:`shard_serve_state` places them (a DTensor already there is
    taken as it is); the logits and every cache leaf come back at the
    cell's out-shardings.  Only the dense family
    (:func:`check_sharded_family`)."""
    run = _sharded_serve(cfg, "prefill", make_prefill_step(cfg), mesh, rules)

    def sharded_prefill_step(params, tokens, caches, extras=None):
        return run(params, tokens, caches, extras or {})

    return sharded_prefill_step


def make_sharded_serve_step(cfg: ArchConfig, mesh, rules: shd.ShardingRules | None = None):
    """:func:`make_serve_step` on a ``DeviceMesh``: ``(params, tokens,
    caches) -> (logits, caches)``, placed as
    :func:`make_sharded_prefill_step` places a prefill."""
    return _sharded_serve(cfg, "decode", make_serve_step(cfg), mesh, rules)
