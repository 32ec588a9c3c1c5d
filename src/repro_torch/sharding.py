"""Logical-axis sharding rules (MaxText-style) for the production mesh.

Port of the rules half of ``repro/sharding.py``.  Parameters and
activations carry *logical* axis names; :func:`logical_to_spec` maps them
onto physical mesh axes.  The default rules implement DP(+pod) x TP with
FSDP: weights are sharded over BOTH the model axis (tensor-parallel
dimension) and the data axis (FSDP dimension).

Logical axes:
  batch    -> (pod, data)      activations' batch dim
  seq      -> None             (sequence-parallel variants map it to model)
  embed    -> fsdp(=data)      d_model dim of weights
  heads    -> model            attention heads / q-proj out dim
  kv_heads -> model
  ffn      -> model            MLP hidden
  vocab    -> model            embedding/lm-head vocab dim
  experts  -> model            MoE expert dim (expert parallelism)
  ssm_in   -> model            mamba d_inner
  layers   -> None             scan dim, never sharded

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` (its
``mesh_dim_names`` and ``mesh.shape``) or a plain ``{axis: size}`` map:
with the map the rules run at the production shape without its ranks.
:func:`logical_to_spec` returns :class:`PartitionSpec`, the port's own
small tuple of one entry per dim (None, an axis name, or a tuple of axis
names), trailing Nones dropped, as JAX's ``PartitionSpec``.
:func:`axis_rank` gives a rank's flattened coordinate over some axes of a
``DeviceMesh`` (which rows and experts are its own).  What a spec
means for an eager tensor (``named_sharding``, ``tree_shardings``,
``constrain``) belongs to the sharded train step, a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    batch: tuple[str, ...] | str | None = ("pod", "data")
    seq: str | None = None
    embed: tuple[str, ...] | str | None = ("pod", "data")  # FSDP axis (ZeRO-3)
    heads: str | None = "model"
    kv_heads: str | None = "model"
    ffn: str | None = "model"
    vocab: str | None = "model"
    experts: str | None = "model"
    ssm_in: str | None = "model"
    expert_capacity: tuple[str, ...] | str | None = ("pod", "data")
    head_dim: str | None = None        # serving: KV-cache head_dim -> model
    layers: None = None

    def axis(self, logical: str | None):
        if logical is None:
            return None
        return getattr(self, logical)


DEFAULT_RULES = ShardingRules()
# the paper-faithful static baseline: weights replicated over data (no FSDP)
NO_FSDP_RULES = dataclasses.replace(DEFAULT_RULES, embed=None)
# serving topology: no FSDP (decode reads every weight once a token; FSDP
# would all-gather the whole model a step) and the KV cache's sequence dim
# over model (covers archs whose head count does not divide the TP axis)
SERVE_RULES = dataclasses.replace(DEFAULT_RULES, embed=None, seq="model")


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), a mesh axis name, or a
    tuple of axis names (sharded over their product, the first the
    outermost).  Trailing Nones are dropped, so specs compare as JAX's
    ``PartitionSpec`` does."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):     # pickling passes the entries, not the tuple
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def mesh_shape(mesh: Any) -> dict[str, int]:
    """A mesh's axis sizes by name: a ``DeviceMesh`` or a ``{axis: size}``
    map."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a mesh for the sharding rules needs mesh_dim_names")
    return dict(zip(names, tuple(mesh.shape)))


def axis_rank(mesh: Any, axes: tuple[str, ...]) -> int:
    """This rank's coordinate over ``axes`` of a ``DeviceMesh`` flattened,
    the first the outermost (the order a tiled gather over them
    concatenates in); 0 over no axes."""
    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    r = 0
    for a in axes:
        i = names.index(a)
        r = r * mesh.shape[i] + coord[i]
    return r


def filter_axes(mesh: Any, axes) -> Any:
    """Drop logical->physical mappings whose physical axis is absent/size-1."""
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    shape = mesh_shape(mesh)
    present = tuple(a for a in axes if a in shape and shape[a] > 1)
    if not present:
        return None
    return present if len(present) > 1 else present[0]


def axes_tuple(phys) -> tuple[str, ...]:
    """A :func:`filter_axes` result as a tuple of axis names (() for None)."""
    if phys is None:
        return ()
    return (phys,) if isinstance(phys, str) else tuple(phys)


def logical_to_spec(mesh: Any, rules: ShardingRules,
                    logical_axes: tuple[str | None, ...],
                    shape: tuple[int, ...] | None = None) -> PartitionSpec:
    """Map a tuple of logical axis names to a :class:`PartitionSpec`.

    If ``shape`` is given, a mapping is dropped when the dim is not divisible
    by the mesh-axis product (e.g. batch=1 long-context can't shard on data).
    A mesh axis shards at most one dim: the first dim that asks wins.
    """
    sizes = mesh_shape(mesh)
    spec = []
    used: set[str] = set()
    for i, name in enumerate(logical_axes):
        cand = tuple(a for a in axes_tuple(filter_axes(sizes, rules.axis(name)))
                     if a not in used)
        if cand and shape is not None:
            sz = 1
            for a in cand:
                sz *= sizes[a]
            if shape[i] % sz:
                cand = ()
        used.update(cand)
        spec.append(None if not cand else cand[0] if len(cand) == 1 else cand)
    while spec and spec[-1] is None:
        spec.pop()
    return PartitionSpec(*spec)


# --- the active mesh (model code has no mesh plumbed through) ---------------
_ACTIVE: list[tuple[Any, ShardingRules]] = []


def set_active(mesh: Any, rules: ShardingRules | None = None) -> None:
    """Install the mesh and rules that model code reads (``moe_fwd``'s
    expert-parallel dispatch); None clears them."""
    _ACTIVE.clear()
    if mesh is not None:
        _ACTIVE.append((mesh, rules or DEFAULT_RULES))


def active() -> "tuple[Any, ShardingRules] | None":
    """The installed ``(mesh, rules)``, or None."""
    return _ACTIVE[0] if _ACTIVE else None
