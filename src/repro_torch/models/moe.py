"""Mixture-of-Experts FFN with sort-based capacity dispatch.

Port of the single-device path of ``repro/models/moe.py`` (``moe_spec``
:34, ``router_topk`` :52, ``moe_fwd`` :181, ``_moe_fwd_local`` :194):

  1. router top-k  ->  (T, k) expert ids + gates,
  2. stable sort of the slot ids; position-in-expert = rank - segment start,
  3. scatter tokens into an (E, C, d) buffer (C = the capacity; slots past
     it are dropped),
  4. batched per-expert SwiGLU on (E, C, d): three ``torch.bmm``,
  5. gather back + combine with gates.

The reference's expert-parallel path (``moe_fwd_ep``, ``set_use_ep``,
``USE_EP``) needs a device mesh and waits for ROADMAP queue 1, "Multi-device,
last"; :func:`moe_fwd` always takes the local path.

Where the port has to choose, it picks what makes the result the
reference's, the same on every run, and traceable on fake tensors:

* Top-k is a stable descending sort and its first k columns.
  ``jax.lax.top_k`` puts the lower expert first among equal scores;
  ``torch.topk`` promises no order for ties, and bf16 router logits tie
  often.  A stable sort keeps the lower index first.
* Position-in-expert comes from a stable sort of the slot ids, as
  ``jnp.argsort`` is stable: it decides which slots the capacity drops.
* No shape depends on the data (the overlay's tracer runs on fake
  tensors): counts per expert are an ``index_add`` into E zeros, the
  capacity ``int(T k / E * capacity_factor) + 1`` is Python arithmetic on
  static shapes, and the dispatch writes every slot (a dropped slot adds
  zeros at position C - 1).
* Nothing is written in place (traced code must be functional): the
  dispatch is ``torch.index_put(..., accumulate=True)``, whose kept slots
  are unique, so its result is exact in any order.
* The combine adds each token's k contributions one at a time, in the
  reference's slot order, from zeros, each add rounded to the activation
  dtype.  The reference's ``zeros_like(x).at[tok].add(...)`` does that;
  an ``index_add`` on the card would sum in whatever order its atomics
  land, and overlay-served and plain logits could differ.

Every product is one ``torch.mm`` (:func:`~repro_torch.models.layers.
linear`) or one ``torch.bmm``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import linear
from repro_torch.models.params import ParamSpec, dense


def moe_spec(cfg: ArchConfig) -> dict:
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    spec = {
        "router": dense(d, e),
        "w_gate": ParamSpec((e, d, f)),
        "w_up": ParamSpec((e, d, f)),
        "w_down": ParamSpec((e, f, d)),
    }
    if cfg.num_shared_experts:
        fs = cfg.moe_d_ff * cfg.num_shared_experts
        spec["shared"] = {
            "w_gate": dense(d, fs),
            "w_up": dense(d, fs),
            "w_down": dense(fs, d),
        }
    return spec


def router_topk(scores_logits: torch.Tensor, cfg: ArchConfig):
    """Top-k routing. Returns (gates (T,k) f32, idx (T,k) int64, aux_loss)."""
    t, e = scores_logits.shape
    k = cfg.experts_per_token
    logits = scores_logits.float()
    if cfg.router_scoring == "sigmoid":        # deepseek-v3
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    # the lower index first among equal scores, as jax.lax.top_k
    ranked, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    gates, idx = ranked[:, :k], order[:, :k]
    gates = gates / (torch.sum(gates, dim=-1, keepdim=True) + 1e-20)

    # Switch-style load-balance loss (reported as a metric; weight in optim):
    # density is the share of tokens routed to each expert
    density = _expert_counts(idx.reshape(-1), e, torch.float32) / t
    router_prob = torch.mean(torch.softmax(logits, dim=-1), dim=0)
    aux = e * torch.sum(density * router_prob) / k
    return gates, idx, aux


def _expert_counts(flat_e: torch.Tensor, e: int, dtype: torch.dtype) -> torch.Tensor:
    """Slots routed to each of the ``e`` experts (the reference's
    ``zeros(e).at[flat_e].add(1)``; ``bincount``'s size would depend on
    the data)."""
    ones = torch.ones(flat_e.shape, dtype=dtype, device=flat_e.device)
    return torch.zeros(e, dtype=dtype, device=flat_e.device).index_add(0, flat_e, ones)


def moe_fwd(p: dict, x: torch.Tensor, cfg: ArchConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (T, d) flat tokens -> (y (T, d), aux_loss).  Always the local
    path: the expert-parallel one needs a mesh (ROADMAP queue 1,
    "Multi-device, last")."""
    return _moe_fwd_local(p, x, cfg)


def _moe_fwd_local(p: dict, x: torch.Tensor, cfg: ArchConfig
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    t, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = int(t * k / e * cfg.capacity_factor) + 1
    dev = x.device

    gates, idx, aux = router_topk(linear(x, p["router"]), cfg)

    # ---- sort-based position-in-expert (O(T·k) memory) ----
    flat_e = idx.reshape(-1)                                     # (T*k,)
    sorted_e, order = torch.sort(flat_e, stable=True)
    counts = _expert_counts(flat_e, e, torch.int64)
    starts = torch.cumsum(counts, 0) - counts                    # (E,)
    pos_sorted = torch.arange(t * k, device=dev) - starts[sorted_e]
    pos = torch.zeros(t * k, dtype=torch.int64, device=dev).index_copy(0, order, pos_sorted)
    keep = pos < cap                                             # capacity drop

    tok = torch.arange(t * k, device=dev) // k                  # token of each slot
    safe_pos = torch.where(keep, pos, cap - 1)
    keep_x = keep[:, None].to(x.dtype)

    # ---- dispatch: scatter into (E, C, d) ----
    buf = torch.zeros((e, cap, d), dtype=x.dtype, device=dev)
    buf = torch.index_put(buf, (flat_e, safe_pos), x[tok] * keep_x, accumulate=True)

    # ---- batched per-expert SwiGLU ----
    h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    out_buf = torch.bmm(h, p["w_down"])

    # ---- combine: gather back, weight by gates, add in slot order ----
    slot_out = out_buf[flat_e, safe_pos] * keep_x
    contrib = (slot_out * gates.reshape(-1)[:, None].to(x.dtype)).reshape(t, k, d)
    y = torch.zeros_like(x)
    for j in range(k):
        y = y + contrib[:, j]

    if "shared" in p:
        sh = p["shared"]
        y = y + linear(F.silu(linear(x, sh["w_gate"])) * linear(x, sh["w_up"]), sh["w_down"])
    return y, aux
