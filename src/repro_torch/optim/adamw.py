"""AdamW with f32 moments (port of ``repro/optim/adamw.py:35-88``).

The moments mirror the parameter tree and are f32 whatever the parameter
dtype; the update is computed in f32 and cast back to the parameter's dtype;
decoupled weight decay applies to matrices only (ndim >= 2) unless a decay
mask says otherwise.  A model's mask is :func:`decay_mask`: the reference
stacks each scanned layer's leaves over its block's repeats, so a layer's
norm scales and 1-D parameters are matrices there and get decayed.  Trees
are nested dicts and lists of tensors (``torch.utils._pytree``).

Two forms of one step, with the same arithmetic per leaf:

* :func:`adamw_update` is functional: it returns new parameters and a new
  state (the reference's form; the overlay traces it).
* :func:`adamw_update_` updates parameters and moments in place, leaf by
  leaf, after taking the global-norm clip scale: the eager train step's
  form.  At phi3-mini's 3.8 B parameters the f32 moments are 30.6 GB, and
  a second copy of them does not fit on one 80 GB card; the traced step
  gets the same by donating its state (``Overlay.jit(...,
  donate_argnums=(0,))``).  A leaf of more than ``SLICE_ELEMENTS``
  elements is updated, and its sum of squares taken, in slices of its flat
  view, so the step's f32 temporaries stay a few slices' size:
  gemma2-27b's tied embedding has 1.18 G elements, and its unsliced update
  would hold ~8 f32 copies of it (~38 GB) at once.  The update is
  elementwise, so slicing moves no bit of it; both forms take the norm so.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils import _pytree as pytree

from repro_torch.sharding import is_dtensor


@dataclasses.dataclass
class OptState:
    step: torch.Tensor       # () int32
    mu: Any                  # first moment, f32, like params
    nu: Any                  # second moment, f32, like params


SLICE_ELEMENTS = 1 << 25      # a larger leaf is updated and summed in slices (128 MiB of f32)


pytree.register_pytree_node(
    OptState,
    lambda s: ((s.step, s.mu, s.nu), None),
    lambda children, _: OptState(*children),
    serialized_type_name="repro_torch.optim.adamw.OptState")


def adamw_init(params: Any) -> OptState:
    leaves = pytree.tree_leaves(params)
    f32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return OptState(step=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
                    mu=pytree.tree_map(f32, params),
                    nu=pytree.tree_map(f32, params))


def opt_state_spec(param_spec: Any) -> OptState:
    """The optimizer state of a :class:`~repro_torch.models.params.ParamSpec`
    tree as specs, allocating nothing (``repro/optim/adamw.py:42-48``): an
    int32 step of no axes and f32 moments of the parameters' shapes and
    logical axes (so a sharded step places each moment as its parameter),
    zero-initialized.  ``params.abstract`` turns it into the avals of
    :func:`adamw_init`'s state."""
    from repro_torch.models.params import ParamSpec, is_spec
    as_f32 = lambda s: dataclasses.replace(s, init="zeros", dtype=torch.float32)  # noqa: E731
    return OptState(step=ParamSpec((), (), "zeros", dtype=torch.int32),
                    mu=pytree.tree_map(as_f32, param_spec, is_leaf=is_spec),
                    nu=pytree.tree_map(as_f32, param_spec, is_leaf=is_spec))


def _slices(t: torch.Tensor) -> list[torch.Tensor]:
    """``t``'s flat view (a copy if ``t`` is strided) in slices of at most
    ``SLICE_ELEMENTS`` elements."""
    flat = t.reshape(-1)
    return [flat[lo:lo + SLICE_ELEMENTS] for lo in range(0, flat.numel(), SLICE_ELEMENTS)]


def _square_sums(g: torch.Tensor) -> list:
    """A leaf's f32 sums of squares, one a slice.  Of a DTensor, those of
    each rank's local shard, each a ``Partial`` sum over the mesh dims that
    shard it (a ``Partial`` leaf is reduced first): a replicated leaf is
    summed in the single-device slices, so in the same roundings."""
    if not is_dtensor(g):
        return [torch.sum(torch.square(s.float())) for s in _slices(g)]
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if any(p.is_partial() for p in g.placements):
        g = g.redistribute(g.device_mesh, [Replicate() if p.is_partial() else p
                                           for p in g.placements])
    placements = [Partial() if p.is_shard() else Replicate() for p in g.placements]
    return [DTensor.from_local(torch.sum(torch.square(s.float())), g.device_mesh, placements,
                               run_check=False)
            for s in _slices(g.to_local())]


def global_norm(grads: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares (leaf order), a
    leaf of more than ``SLICE_ELEMENTS`` elements summed slice by slice.
    Of DTensor leaves, a replicated scalar DTensor."""
    return torch.sqrt(sum(s for g in pytree.tree_leaves(grads) for s in _square_sums(g)))


def _placed_like(grads: Any, params: Any) -> Any:
    """Each DTensor gradient redistributed to its parameter's placements
    (a ``Partial`` gradient of a sharded parameter is reduce-scattered:
    FSDP's gradient reduction); plain gradients are returned as they are."""
    def place(g, p):
        if not is_dtensor(g) or tuple(g.placements) == tuple(p.placements):
            return g
        return g.redistribute(p.device_mesh, p.placements)
    flat_p, spec = pytree.tree_flatten(params)
    return pytree.tree_unflatten([place(g, p) for g, p in zip(spec.flatten_up_to(grads), flat_p)],
                                 spec)


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)


def clip_by_global_norm(grads: Any, max_norm: float):
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, max_norm)
    return pytree.tree_map(lambda g: g.float() * scale, grads), gnorm


# the subtrees whose leaves the reference stacks over a block's repeats
STACKED_SUBTREES = ("layers", "enc_layers")


def decay_mask(params: Any) -> Any:
    """Which leaves of a model's parameter tree AdamW decays, as a tree of
    bools: the leaves the reference holds as matrices.  That is every leaf
    with ndim >= 2, and every 1-D leaf of a scanned layer (under
    ``STACKED_SUBTREES``), which the reference holds as ``(repeats, d)``.
    The shared set and the ``mtp`` module are unstacked in both packages,
    so their vectors stay undecayed."""
    def decays(path, p) -> bool:
        stacked = bool(path) and getattr(path[0], "key", None) in STACKED_SUBTREES
        return p.dim() + stacked >= 2
    return pytree.tree_map_with_path(decays, params)


def _decays(params: Any, spec, decay: Any) -> list[bool]:
    """The decay flag of each leaf of ``params`` (leaf order): ``decay``'s
    where given, else ndim >= 2."""
    if decay is None:
        return [p.dim() >= 2 for p in pytree.tree_leaves(params)]
    return [bool(d) for d in spec.flatten_up_to(decay)]


def _leaf_update(p, g, m, v, *, lr, b1, b2, eps, weight_decay, b1c, b2c, matrix):
    """One leaf's AdamW update from its clipped f32 gradient ``g``
    (``matrix``: the leaf is decayed; ``p`` may be a slice of its flat
    view).  Returns (new_p, new_m, new_v)."""
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * torch.square(g)
    mhat = m / b1c
    vhat = v / b2c
    delta = mhat / (torch.sqrt(vhat) + eps)
    # decoupled weight decay on matrices only (the reference's ndim >= 2)
    if matrix:
        delta = delta + weight_decay * p.float()
    new_p = (p.float() - lr * delta).to(p.dtype)
    return new_p, m, v


def _bias_corrections(step: torch.Tensor, b1: float, b2: float):
    stepf = step.float()
    return 1.0 - b1 ** stepf, 1.0 - b2 ** stepf


def adamw_update(params: Any, grads: Any, state: OptState, *,
                 lr: "float | torch.Tensor", b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 max_grad_norm: float = 1.0, decay: Any = None):
    """One AdamW step. Returns (new_params, new_state, metrics).
    ``decay``: a tree of bools like ``params`` naming the leaves to decay
    (a model's is :func:`decay_mask`); None decays those with ndim >= 2.
    DTensor leaves (the sharded step): each gradient is first brought to
    its parameter's placements, and the update runs on each rank's shard;
    ``grad_norm`` is a replicated scalar."""
    grads, gnorm = clip_by_global_norm(_placed_like(grads, params), max_grad_norm)
    step = state.step + 1
    b1c, b2c = _bias_corrections(step, b1, b2)
    flat_p, spec = pytree.tree_flatten(params)
    out = [_leaf_update(p, g, m, v, lr=lr, b1=b1, b2=b2, eps=eps,
                        weight_decay=weight_decay, b1c=b1c, b2c=b2c, matrix=dec)
           for p, g, m, v, dec in zip(flat_p, spec.flatten_up_to(grads),
                                 spec.flatten_up_to(state.mu),
                                 spec.flatten_up_to(state.nu),
                                 _decays(params, spec, decay))]
    new = [pytree.tree_unflatten([o[i] for o in out], spec) for i in range(3)]
    return new[0], OptState(step, new[1], new[2]), {"grad_norm": gnorm}


@torch.no_grad()
def adamw_update_(params: Any, grads: list, state: OptState, *,
                  lr: "float | torch.Tensor", b1: float = 0.9, b2: float = 0.95,
                  eps: float = 1e-8, weight_decay: float = 0.1,
                  max_grad_norm: float = 1.0, decay: Any = None) -> dict:
    """:func:`adamw_update` in place: ``params``, ``state.mu``, ``state.nu``
    and ``state.step`` are overwritten with the values adamw_update would
    return.  ``grads`` is the list of the parameters' gradients in leaf
    order; each entry is dropped once its leaf is updated.  A leaf of more
    than ``SLICE_ELEMENTS`` elements is updated in slices of that many
    elements of its flat view.  ``decay`` as in :func:`adamw_update`.
    Returns the metrics."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, max_grad_norm)
    state.step.add_(1)
    b1c, b2c = _bias_corrections(state.step, b1, b2)
    flat_p, spec = pytree.tree_flatten(params)
    decays = _decays(params, spec, decay)
    for i, (p, m, v) in enumerate(zip(flat_p, spec.flatten_up_to(state.mu),
                                      spec.flatten_up_to(state.nu))):
        # view(-1): the slices of p, m and v are written in place
        for ps, gs, ms, vs in zip(*map(_slices, (p.view(-1), grads[i], m.view(-1),
                                                 v.view(-1)))):
            new_p, new_m, new_v = _leaf_update(
                ps, gs.float() * scale, ms, vs, lr=lr, b1=b1, b2=b2, eps=eps,
                weight_decay=weight_decay, b1c=b1c, b2c=b2c, matrix=decays[i])
            ps.copy_(new_p)
            ms.copy_(new_m)
            vs.copy_(new_v)
            del new_p, new_m, new_v       # before the next slice's temporaries
        grads[i] = gs = None              # the gradient and its last slice
    return {"grad_norm": gnorm}
