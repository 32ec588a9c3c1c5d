"""Mixture-of-Experts FFN with sort-based capacity dispatch.

Port of ``repro/models/moe.py`` (``moe_spec`` :34, ``router_topk`` :52,
``moe_fwd_ep`` :82, ``moe_fwd`` :181, ``_moe_fwd_local`` :194).  The local
path:

  1. router top-k  ->  (T, k) expert ids + gates,
  2. stable sort of the slot ids; position-in-expert = rank - segment start,
  3. scatter tokens into an (E, C, d) buffer (C = the capacity; slots past
     it are dropped),
  4. batched per-expert SwiGLU on (E, C, d): three ``torch.bmm``,
  5. gather back + combine with gates.

Expert parallelism (:func:`moe_fwd_ep`): experts are split over the
``model`` axis of a ``DeviceMesh``, tokens over the batch axes, and each
rank runs the reference's shard_map body on ``torch.distributed``: it
routes its own rows, keeps only its own experts' slots, all-gathers its
experts' FSDP weight shards over the data axes, and ``all_reduce``-sums
the output (averages the aux loss) over the model axis.  :func:`moe_fwd`
takes it when an active mesh (``sharding.set_active``) has more than one
rank.

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

import dataclasses
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch import sharding as shd
from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import linear
from repro_torch.models.params import ParamSpec, dense


def moe_spec(cfg: ArchConfig) -> dict:
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    spec = {
        "router": dense(d, e, None, None),   # tiny; replicated for EP dispatch
        "w_gate": ParamSpec((e, d, f), ("experts", "embed", None)),
        "w_up": ParamSpec((e, d, f), ("experts", "embed", None)),
        "w_down": ParamSpec((e, f, d), ("experts", None, "embed")),
    }
    if cfg.num_shared_experts:
        fs = cfg.moe_d_ff * cfg.num_shared_experts
        spec["shared"] = {
            "w_gate": dense(d, fs, "embed", "ffn"),
            "w_up": dense(d, fs, "embed", "ffn"),
            "w_down": dense(fs, d, "ffn", "embed"),
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


def _dispatch_positions(flat_e: torch.Tensor, e: int) -> torch.Tensor:
    """Sort-based position-in-expert of each slot of a flat slot->expert
    assignment (O(T·k) memory): a stable sort, then rank minus the
    expert's segment start."""
    n = flat_e.shape[0]
    sorted_e, order = torch.sort(flat_e, stable=True)
    counts = _expert_counts(flat_e, e, torch.int64)
    starts = torch.cumsum(counts, 0) - counts                    # (E,)
    pos_sorted = torch.arange(n, device=flat_e.device) - starts[sorted_e]
    return torch.zeros(n, dtype=torch.int64, device=flat_e.device).index_copy(
        0, order, pos_sorted)


def _swiglu_experts(buf: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """Batched per-expert SwiGLU on (E, C, d): three ``torch.bmm``."""
    h = F.silu(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
    return torch.bmm(h, w_down)


def _combine(slot_out: torch.Tensor, gates: torch.Tensor, t: int, k: int,
             like: torch.Tensor) -> torch.Tensor:
    """Each token's k weighted slot outputs added one at a time, in slot
    order, from zeros, each add rounded to the activation dtype."""
    contrib = (slot_out * gates.reshape(-1)[:, None].to(like.dtype)).reshape(t, k, -1)
    y = torch.zeros_like(like)
    for j in range(k):
        y = y + contrib[:, j]
    return y


def _shared_fwd(sh: dict, x: torch.Tensor) -> torch.Tensor:
    return linear(F.silu(linear(x, sh["w_gate"])) * linear(x, sh["w_up"]), sh["w_down"])


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class EPLayout:
    """How ``moe_fwd_ep`` cuts one call over a mesh (the reference's
    arithmetic, ``repro/models/moe.py:98-126``): experts ``e_loc`` a rank
    over ``model`` (absent at size 1), tokens ``t_loc`` a rank over
    ``batch_axes`` (none when the tokens do not divide: every rank takes
    all of them), the experts' ``d`` dim over ``fsdp_axes`` (none when
    ``d`` does not divide), and a per-rank capacity."""
    model_axis: "str | None"
    n_model: int
    e_loc: int
    batch_axes: tuple[str, ...]
    n_data: int
    t_loc: int
    fsdp_axes: tuple[str, ...]
    n_fsdp: int
    cap: int


def ep_layout(cfg: ArchConfig, mesh, rules, t: int, d: int) -> EPLayout:
    e, k = cfg.num_experts, cfg.experts_per_token
    sizes = shd.mesh_shape(mesh)
    n_model = sizes.get("model", 1)
    model_axis = "model" if n_model > 1 else None
    if e % n_model:
        raise ValueError(f"experts {e} not divisible by model axis {n_model}")
    # the FSDP axes come from the active rules, not from the mesh: serving
    # rules turn FSDP off (weights replicated over data)
    fsdp_axes = shd.axes_tuple(shd.filter_axes(sizes, rules.embed))
    batch_axes = shd.axes_tuple(shd.filter_axes(sizes, rules.batch))
    n_data = math.prod(sizes[a] for a in batch_axes)
    if t % n_data:          # token count not shardable -> replicate tokens
        batch_axes, n_data = (), 1
    t_loc = t // n_data
    # the reference tests d against the batch shard count here
    if fsdp_axes and d % n_data:
        fsdp_axes = ()
    return EPLayout(model_axis, n_model, e // n_model, batch_axes, n_data, t_loc,
                    fsdp_axes, math.prod(sizes[a] for a in fsdp_axes),
                    int(t_loc * k / e * cfg.capacity_factor) + 1)


def ep_shards(p: dict, cfg: ArchConfig, mesh, rules, t: int) -> dict:
    """This rank's cut of a full MoE tree, as the reference's ``w_spec``
    and ``w_down_spec`` cut it (``repro/models/moe.py:121-126``): its
    ``e_loc`` experts, and of those its block of ``d`` over the FSDP axes.
    The router and the shared expert stay whole."""
    lay = ep_layout(cfg, mesh, rules, t, p["router"].shape[0])
    m = shd.axis_rank(mesh, (lay.model_axis,) if lay.model_axis else ())
    f = shd.axis_rank(mesh, lay.fsdp_axes)
    experts = slice(m * lay.e_loc, (m + 1) * lay.e_loc)
    out = dict(p)
    for name, dim in (("w_gate", 1), ("w_up", 1), ("w_down", 2)):
        w = p[name][experts]
        n = w.shape[dim] // lay.n_fsdp
        out[name] = w.narrow(dim, f * n, n).contiguous()
    return out


def _all_gather(t: torch.Tensor, mesh, axes: tuple[str, ...], dim: int) -> torch.Tensor:
    """``t``'s blocks of every rank over ``axes`` concatenated along
    ``dim`` in the axes' flattened order (the reference's tiled
    ``all_gather``): one ``all_gather_into_tensor`` an axis, the
    innermost first."""
    for axis in reversed(axes):
        group = mesh.get_group(axis)
        n = dist.get_world_size(group)
        src = t.movedim(dim, 0).contiguous()
        out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        dist.all_gather_into_tensor(out, src, group=group)
        t = out.movedim(0, dim).contiguous()
    return t


def moe_fwd_ep(p: dict, x: torch.Tensor, cfg: ArchConfig, mesh,
               rules) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE on this rank: ``p`` holds the rank's weight
    shards (:func:`ep_shards`), ``x`` all ``(T, d)`` tokens, replicated.
    Returns the rank's own rows of the output, ``(t_loc, d)`` (all T when
    the tokens do not divide over the batch axes), and the aux loss.

    Activations are replicated over ``model``, so every model rank keeps
    the slots routed to its own experts locally and dispatch costs no
    communication; the collectives are the FSDP weight all-gather (over
    the data axes) and one sum of the combined output (over ``model``)."""
    e, k = cfg.num_experts, cfg.experts_per_token
    t, d = x.shape
    lay = ep_layout(cfg, mesh, rules, t, d)
    dev = x.device
    row = shd.axis_rank(mesh, lay.batch_axes)
    x_loc = x[row * lay.t_loc:(row + 1) * lay.t_loc]
    w_gate, w_up, w_down = p["w_gate"], p["w_up"], p["w_down"]
    if lay.fsdp_axes:      # ZeRO-3: gather the d shard of the expert weights
        w_gate = _all_gather(w_gate, mesh, lay.fsdp_axes, 1)
        w_up = _all_gather(w_up, mesh, lay.fsdp_axes, 1)
        w_down = _all_gather(w_down, mesh, lay.fsdp_axes, 2)

    gates, idx, aux = router_topk(linear(x_loc, p["router"]), cfg)
    eid0 = shd.axis_rank(mesh, (lay.model_axis,) if lay.model_axis else ()) * lay.e_loc
    flat_e = idx.reshape(-1)
    tok = torch.arange(lay.t_loc * k, device=dev) // k
    mine = (flat_e >= eid0) & (flat_e < eid0 + lay.e_loc)
    pos = _dispatch_positions(flat_e, e)
    keep = mine & (pos < lay.cap)
    loc_e = torch.clamp(flat_e - eid0, 0, lay.e_loc - 1)
    safe_pos = torch.where(keep, pos, lay.cap - 1)
    keep_x = keep[:, None].to(x.dtype)

    buf = torch.zeros((lay.e_loc, lay.cap, d), dtype=x.dtype, device=dev)
    buf = torch.index_put(buf, (loc_e, safe_pos), x_loc[tok] * keep_x, accumulate=True)
    out_buf = _swiglu_experts(buf, w_gate, w_up, w_down)
    y = _combine(out_buf[loc_e, safe_pos] * keep_x, gates, lay.t_loc, k, x_loc)
    if lay.model_axis:
        group = mesh.get_group(lay.model_axis)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        dist.all_reduce(aux, op=dist.ReduceOp.SUM, group=group)
        aux = aux / lay.n_model
    if "shared" in p:      # outside the EP body, as the reference adds it
        y = y + _shared_fwd(p["shared"], x_loc)
    return y, aux


def moe_fwd(p: dict, x: torch.Tensor, cfg: ArchConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (T, d) flat tokens -> (y (T, d), aux_loss).

    Takes the expert-parallel path when an active mesh has more than one
    rank, else the local one.  Until the sharded train
    step hands the model real shards, the model's tree is whole on every
    rank: this cuts the rank's shards from it (:func:`ep_shards`) and
    gathers the output's rows back over the batch axes, so the rest of the
    model sees the ``(T, d)`` the local path gives.  The aux loss is then
    the mean of the batch ranks' own."""
    act = shd.active()
    if act is not None and math.prod(shd.mesh_shape(act[0]).values()) > 1:
        mesh, rules = act
        t, d = x.shape
        y, aux = moe_fwd_ep(ep_shards(p, cfg, mesh, rules, t), x, cfg, mesh, rules)
        lay = ep_layout(cfg, mesh, rules, t, d)
        if lay.batch_axes:
            y = _all_gather(y, mesh, lay.batch_axes, 0)
            aux = _all_gather(aux.reshape(1), mesh, lay.batch_axes, 0).mean()
        return y, aux
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
    pos = _dispatch_positions(flat_e, e)
    keep = pos < cap                                             # capacity drop

    tok = torch.arange(t * k, device=dev) // k                  # token of each slot
    safe_pos = torch.where(keep, pos, cap - 1)
    keep_x = keep[:, None].to(x.dtype)

    # ---- dispatch: scatter into (E, C, d) ----
    buf = torch.zeros((e, cap, d), dtype=x.dtype, device=dev)
    buf = torch.index_put(buf, (flat_e, safe_pos), x[tok] * keep_x, accumulate=True)

    # ---- batched per-expert SwiGLU ----
    out_buf = _swiglu_experts(buf, p["w_gate"], p["w_up"], p["w_down"])

    # ---- combine: gather back, weight by gates, add in slot order ----
    y = _combine(out_buf[flat_e, safe_pos] * keep_x, gates, t, k, x)

    if "shared" in p:
        y = y + _shared_fwd(p["shared"], x)
    return y, aux
