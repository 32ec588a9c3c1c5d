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
launcher runs).  The
shardings (the reference's ``batch_shardings`` and ``cell_shardings``,
:104 on) wait for multi-device work (ROADMAP queue 1 item 4).
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils import _pytree as pytree

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
    extras = {}
    if cfg.frontend == "vision":
        extras["patch_embeds"] = TensorSpec((batch, _npatch(seq), cfg.frontend_dim),
                                            torch.bfloat16, dev)
    if cfg.is_encdec:
        extras["enc_in"] = TensorSpec((batch, seq, cfg.frontend_dim), torch.bfloat16, dev)
    return {"tokens": TensorSpec((batch, seq), torch.int32, dev), "caches": caches,
            "extras": extras}


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
