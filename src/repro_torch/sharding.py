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
``DeviceMesh`` (which rows and experts are its own).

What a spec means for an eager tensor: :func:`named_sharding` returns the
port's :class:`NamedSharding`, a ``(mesh, spec)`` pair whose
:meth:`~NamedSharding.placements` are DTensor placements
(``torch.distributed.tensor``): ``Shard(i)`` on every mesh dim that entry
``i`` of the spec names, ``Replicate()`` on the others.  DTensor lays a
dim sharded over several mesh dims out in the mesh's dim order, the first
the outermost, which is JAX's order for a tuple entry only when the tuple
follows the mesh's order: a spec whose tuple does not is refused.
:func:`tree_shardings` maps a tree of logical axes (and shapes);
:func:`constrain` and :func:`constrain_logical` redistribute a DTensor
activation to its spec, the counterpart of ``with_sharding_constraint``
(the reference's GSPMD step; the port's sharded step is the single-device
step run on DTensors, ``launch/steps.py``).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any

from torch.utils import _pytree as pytree


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


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (none can be unless DTensor's module is
    loaded, so asking imports nothing)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def mesh_axes(mesh: Any) -> tuple[str, ...]:
    """A mesh's axis names in its dim order."""
    return tuple(mesh_shape(mesh))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A :class:`PartitionSpec` on a mesh (a ``DeviceMesh`` or an ``{axis:
    size}`` map), as JAX's ``NamedSharding``.  A tuple entry must name its
    axes in the mesh's order (``ValueError`` otherwise)."""

    mesh: Any
    spec: PartitionSpec

    def __post_init__(self):
        names = mesh_axes(self.mesh)
        for entry in self.spec:
            axes = axes_tuple(entry)
            if any(a not in names for a in axes):
                raise ValueError(f"spec {self.spec} names an axis that the mesh {names} lacks")
            order = [names.index(a) for a in axes]
            if order != sorted(order):
                raise ValueError(
                    f"spec {self.spec}: the tuple {entry} is not in the mesh's order {names}; "
                    f"DTensor would lay its shards out in the mesh's order, not the tuple's")

    def placements(self) -> tuple:
        """DTensor placements, one per mesh dim: ``Shard(i)`` where the
        spec's entry ``i`` names the dim, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard
        names = mesh_axes(self.mesh)
        out: list = [Replicate()] * len(names)
        for i, entry in enumerate(self.spec):
            for a in axes_tuple(entry):
                out[names.index(a)] = Shard(i)
        return tuple(out)


def named_sharding(mesh: Any, rules: ShardingRules,
                   logical_axes: tuple[str | None, ...],
                   shape: tuple[int, ...] | None = None) -> NamedSharding:
    return NamedSharding(mesh, logical_to_spec(mesh, rules, logical_axes, shape))


def _is_axes(v) -> bool:
    return isinstance(v, tuple) and all(isinstance(e, (str, type(None))) for e in v)


def tree_shardings(mesh: Any, rules: ShardingRules, tree_axes: Any,
                   tree_shapes: Any = None) -> Any:
    """A tree of logical-axes tuples (and optionally the same tree of
    shapes) as :class:`NamedSharding` leaves."""
    if tree_shapes is None:
        return pytree.tree_map(lambda ax: named_sharding(mesh, rules, ax), tree_axes,
                               is_leaf=_is_axes)
    return pytree.tree_map(lambda ax, shp: named_sharding(mesh, rules, ax, tuple(shp)),
                           tree_axes, tree_shapes, is_leaf=_is_axes)


def constrain(x, mesh: Any, rules: ShardingRules, logical_axes: tuple[str | None, ...]):
    """``x`` redistributed to the spec of its logical axes and shape (the
    reference's ``with_sharding_constraint``).  A no-op without a mesh and
    on a tensor that is not a DTensor (a plain tensor lives whole on its
    rank: the expert-parallel path under an active mesh runs on those)."""
    if mesh is None or not is_dtensor(x):
        return x
    if x.device_mesh != mesh:
        raise ValueError("constrain: the DTensor lives on another mesh than the one given")
    want = named_sharding(mesh, rules, logical_axes, tuple(x.shape)).placements()
    return x if tuple(x.placements) == want else x.redistribute(mesh, want)


# --- the active mesh (model code has no mesh plumbed through) ---------------
_ACTIVE: list[tuple[Any, ShardingRules]] = []


def set_active(mesh: Any, rules: ShardingRules | None = None) -> None:
    """Install the mesh and rules that model code reads (``moe_fwd``'s
    expert-parallel dispatch, :func:`constrain_logical`); None clears
    them."""
    _ACTIVE.clear()
    if mesh is not None:
        _ACTIVE.append((mesh, rules or DEFAULT_RULES))


def active() -> "tuple[Any, ShardingRules] | None":
    """The installed ``(mesh, rules)``, or None."""
    return _ACTIVE[0] if _ACTIVE else None


def constrain_logical(x, logical_axes: tuple[str | None, ...]):
    """:func:`constrain` against the active mesh and rules; ``x`` unchanged
    when none is installed."""
    if not _ACTIVE:
        return x
    mesh, rules = _ACTIVE[0]
    return constrain(x, mesh, rules, logical_axes)
