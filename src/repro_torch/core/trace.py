"""Tracing frontend — plain PyTorch functions become overlay accelerators (C1).

The paper's programmers write *ordinary source code with symbolic links to
library patterns*; the runtime resolves those links and JIT-assembles the
accelerator.  :func:`trace_to_graph` captures a plain PyTorch function at the
aten level and lowers each op onto :mod:`repro_torch.core.patterns` library
operators, producing a :class:`~repro_torch.core.graph.Graph` as IR.  From
there the usual pipeline applies: placement -> controller ISA -> JIT
assembly -> bitstream cache.

Capture: ``torch.fx.experimental.proxy_tensor.make_fx`` on fake tensors.
Its aten-level graph is the nearest counterpart of ``jax.make_jaxpr``: every
op of the function as it actually ran, with shapes, independent of Python
control structure.  ``torch.fx.symbolic_trace`` works on Python-level calls
instead and trips over the decode step's dict caches and per-row positions
(it cannot index a proxy by a data-dependent value or iterate a proxy), so
it is not used.  Fake tensors mean capture runs no kernel and allocates no
device memory, whatever the model's size.

Lowering policy, per aten node:

1. ``aten.where.self`` becomes a :meth:`Graph.select` node — the overlay's
   *speculative branch* (both arms execute, predicate picks; C4).
2. A custom op registered with ``patterns.register_call`` (how ``kernels/``
   exposes its CUDA kernels) becomes ONE LARGE node.
3. The primitive registry is consulted (``aten.mul.Tensor``,
   ``aten.sum.dim_IntList``, ``aten.sqrt.default``, ``aten.mm.default``, ...).
4. Anything unmapped is either an error (``strict=True``) or *residue*: one
   SMALL operator that re-runs the aten op with its constant arguments
   baked in.  Residue ops are recorded on the returned :class:`Lowered`.

Multi-result residue ops (``aten.split``, ``aten.max.dim``, ...) lower to one
tuple-valued node plus per-result ``proj[i]`` nodes (fx's ``getitem``), so
each Graph edge carries one value.

Every operator the lowering makes carries its serial form
(:attr:`~repro_torch.core.patterns.Operator.desc`): a residue or a custom
call names its aten overload and its constant arguments in a tagged form
(:func:`encode_value`), a projection its index.  A residue's computation is
built from an argument template (:class:`_In` placeholders where the fx
nodes stood), so the traced operator and the one the bitstream store
rebuilds (:func:`operator_from_desc`) run the same code.

Traced functions must not mutate their inputs or views of intermediate
values in place: route copies on an edge would break that aliasing.  The
port's model code is functional.
"""

from __future__ import annotations

import dataclasses
import hashlib
import operator
from typing import Any, Callable

import torch
import torch.fx as fx
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils import _pytree as pytree

from repro_torch.core import patterns
from repro_torch.core.graph import Graph, NodeRef, TensorSpec
from repro_torch.core.patterns import Operator, TileClass

RESIDUE_PREFIX = "aten["


class TraceError(RuntimeError):
    """An op could not be lowered onto the operator library."""


@dataclasses.dataclass
class Lowered:
    """The product of tracing: a Graph plus calling-convention metadata."""

    graph: Graph
    out_tree: Any                 # TreeSpec of the function result
    unmapped: tuple[str, ...]     # aten ops left as residue


def _spec(val) -> Any:
    if isinstance(val, torch.Tensor):
        return TensorSpec(tuple(val.shape), val.dtype, val.device)
    if isinstance(val, (tuple, list)):
        return tuple(_spec(v) for v in val)
    return val


def _node_leaves(obj) -> list:
    """The fx nodes among an op's arguments, in the order the operator
    takes them as inputs (depth-first through lists, tuples and kwargs)."""
    if isinstance(obj, fx.Node):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [n for o in obj for n in _node_leaves(o)]
    if isinstance(obj, dict):
        return [n for o in obj.values() for n in _node_leaves(o)]
    return []


class _In:
    """Placeholder for an operator's i-th input inside a residue's argument
    template (where the fx node stood)."""

    __slots__ = ("i",)

    def __init__(self, i: int) -> None:
        self.i = i


def _template(obj, counter: list) -> Any:
    """``obj`` with each fx node replaced by an :class:`_In` placeholder,
    numbered in :func:`_node_leaves` order."""
    if isinstance(obj, fx.Node):
        counter[0] += 1
        return _In(counter[0] - 1)
    if isinstance(obj, (list, tuple)) and _node_leaves(obj):
        kind = list if isinstance(obj, list) else tuple
        return kind(_template(o, counter) for o in obj)
    return obj


def _has_input(obj) -> bool:
    if isinstance(obj, _In):
        return True
    return isinstance(obj, (list, tuple)) and any(_has_input(o) for o in obj)


def _binder(obj) -> Callable[[tuple], Any]:
    """A function rebuilding a template with its i-th placeholder replaced
    by the i-th input — built once, cheap on every call."""
    if isinstance(obj, _In):
        i = obj.i
        return lambda xs: xs[i]
    if isinstance(obj, (list, tuple)) and _has_input(obj):
        parts = [_binder(o) for o in obj]
        kind = list if isinstance(obj, list) else tuple
        return lambda xs: kind(p(xs) for p in parts)
    return lambda xs: obj


def _template_fn(target, targs: tuple, tkwargs: dict) -> Callable[..., Any]:
    """The computation of a residue or custom-call node: ``target`` called
    with its constant arguments baked in and its inputs bound in order."""
    bind_args = [_binder(a) for a in targs]
    bind_kwargs = {k: _binder(v) for k, v in tkwargs.items()}

    def fn(*xs, _t=target):
        out = _t(*(b(xs) for b in bind_args),
                 **{k: b(xs) for k, b in bind_kwargs.items()})
        return tuple(out) if isinstance(out, list) else out

    return fn


def _template_desc(target, targs: tuple, tkwargs: dict):
    """The serial form of a residue, or None when a constant argument has
    no tagged form (a kernel holding it is then not persisted)."""
    if not isinstance(target, torch._ops.OpOverload):
        return None
    try:
        return {"k": "aten", "target": str(target),
                "args": [encode_value(a) for a in targs],
                "kwargs": {k: encode_value(v) for k, v in tkwargs.items()}}
    except SerialError:
        return None


def _residue_operator(target, args, kwargs) -> Operator:
    """Wrap an unmapped aten op as a residue operator: its fx-node arguments
    become the operator's inputs (:func:`_node_leaves` order), everything
    else is baked in."""
    counter = [0]
    targs = tuple(_template(a, counter) for a in args)
    tkwargs = {k: _template(v, counter) for k, v in kwargs.items()}
    # two residues of one op with different constant args must not alias in
    # the bitstream cache
    consts = [("node" if isinstance(a, fx.Node) else repr(a))
              for a in pytree.tree_leaves((args, kwargs))]
    sig = hashlib.sha256(repr((list(kwargs), consts)).encode()).hexdigest()[:12]
    return Operator(name=f"{RESIDUE_PREFIX}{_op_name(target)}]", arity=counter[0],
                    fn=_template_fn(target, targs, tkwargs),
                    tile_class=TileClass.SMALL, signature=sig,
                    desc=_template_desc(target, targs, tkwargs))


def _op_name(target) -> str:
    name = str(target)
    return name.removeprefix("aten.")


def _projection(i: int) -> Operator:
    return Operator(name=f"proj[{i}]", arity=1, fn=lambda t, _i=i: t[_i],
                    tile_class=TileClass.SMALL, flops_per_elem=0.0,
                    desc={"k": "proj", "i": i})


def _custom_call_operator(target, args, kwargs, op: Operator) -> Operator:
    """One opaque LARGE node for a registered custom op.  Identity and tile
    class come from the registration; the computation re-calls the op with
    this call's own constant arguments (e.g. rmsnorm's eps)."""
    res = _residue_operator(target, args, kwargs)
    desc = res.desc and {**res.desc, "k": "call",
                         "call": target._schema.name}
    return dataclasses.replace(res, name=op.name, tile_class=op.tile_class,
                               flops_per_elem=op.flops_per_elem, desc=desc)


# --------------------------------------------------------------------------
# serial form of operators (what the bitstream store writes for a kernel)
# --------------------------------------------------------------------------
class SerialError(ValueError):
    """A value or operator descriptor has no serial form, or names
    something this process cannot resolve."""


_ENUMS = {"dtype": torch.dtype, "layout": torch.layout,
          "memory_format": torch.memory_format}


def encode_value(v) -> list:
    """A constant argument in tagged JSON form: int, float, bool, None, str,
    ``torch.dtype`` / ``device`` / ``layout`` / ``memory_format``, input
    placeholders, and lists and tuples of these.  Raises
    :class:`SerialError` on anything else."""
    if isinstance(v, _In):
        return ["in", v.i]
    if v is None:
        return ["none"]
    if isinstance(v, bool):
        return ["bool", v]
    if isinstance(v, int):
        return ["int", v]
    if isinstance(v, float):
        return ["float", repr(v)]          # repr round-trips, inf and nan too
    if isinstance(v, str):
        return ["str", v]
    if isinstance(v, torch.device):
        return ["device", str(v)]
    for tag, cls in _ENUMS.items():
        if isinstance(v, cls):
            return [tag, str(v).removeprefix("torch.")]
    if isinstance(v, (list, tuple)):
        return ["list" if isinstance(v, list) else "tuple",
                [encode_value(x) for x in v]]
    raise SerialError(f"no serial form for a constant of type {type(v).__name__}")


def decode_value(t):
    """Inverse of :func:`encode_value`; raises :class:`SerialError` on a tag
    or a name it cannot resolve."""
    if not isinstance(t, list) or not t or not isinstance(t[0], str):
        raise SerialError(f"malformed tagged value {t!r}")
    tag, body = t[0], t[1:]
    try:
        if tag == "none":
            return None
        (val,) = body
        if tag == "in":
            return _In(_typed(val, int))
        if tag == "bool":
            return _typed(val, bool)
        if tag == "int":
            return _typed(val, int)
        if tag == "float":
            return float(_typed(val, str))
        if tag == "str":
            return _typed(val, str)
        if tag == "device":
            return torch.device(_typed(val, str))
        if tag in _ENUMS:
            out = getattr(torch, _typed(val, str), None)
            if not isinstance(out, _ENUMS[tag]):
                raise SerialError(f"unknown {tag} {val!r}")
            return out
        if tag in ("list", "tuple"):
            items = [decode_value(x) for x in _typed(val, list)]
            return items if tag == "list" else tuple(items)
    except (TypeError, ValueError, RuntimeError) as exc:
        if isinstance(exc, SerialError):
            raise
        raise SerialError(f"bad tagged value {t!r}: {exc}") from None
    raise SerialError(f"unknown tag {tag!r}")


def _typed(v, cls):
    if cls is int and isinstance(v, bool) or not isinstance(v, cls):
        raise SerialError(f"expected {cls.__name__}, got {v!r}")
    return v


def _resolve_target(name) -> "torch._ops.OpOverload":
    """An op overload by its qualified name (``"aten.mul.Tensor"``,
    ``"repro_torch.rmsnorm.default"``), looked up, never imported or run."""
    parts = name.split(".") if isinstance(name, str) else ()
    if len(parts) != 3 or not all(p.isidentifier() for p in parts):
        raise SerialError(f"malformed op overload name {name!r}")
    if parts[0] == "repro_torch":
        import repro_torch.kernels.ops  # noqa: F401  (registers the custom ops)
    try:
        target = getattr(getattr(getattr(torch.ops, parts[0]), parts[1]), parts[2])
    except (AttributeError, RuntimeError):
        target = None
    if not isinstance(target, torch._ops.OpOverload):
        raise SerialError(f"unknown op overload {name!r}")
    return target


def operator_from_desc(desc) -> Operator:
    """Rebuild an operator from its serial form (:attr:`Operator.desc`).
    Library entries, patterns, casts and registered calls resolve by name;
    residues by their aten overload and tagged constants.  Raises
    :class:`SerialError` on anything it cannot resolve."""
    if not isinstance(desc, dict):
        raise SerialError(f"malformed operator descriptor {desc!r}")
    kind = desc.get("k")
    try:
        if kind == "lib":
            name = desc["name"]
            if not isinstance(name, str) or name not in patterns.LIBRARY:
                raise SerialError(f"unknown library operator {name!r}")
            return patterns.LIBRARY[name]
        if kind == "map":
            return patterns.make_map(operator_from_desc(desc["op"]))
        if kind == "zip":
            return patterns.make_zip_with(operator_from_desc(desc["op"]))
        if kind == "reduce":
            axis = desc["axis"]
            if isinstance(axis, list):
                axis = tuple(_typed(a, int) for a in axis)
            elif axis is not None:
                axis = _typed(axis, int)
            return patterns.make_reduce(operator_from_desc(desc["op"]), axis)
        if kind == "cast":
            return patterns.make_cast(decode_value(["dtype", desc["dtype"]]))
        if kind == "proj":
            return _projection(_typed(desc["i"], int))
        if kind == "callop":
            if _typed(desc["call"], str).startswith("repro_torch::"):
                import repro_torch.kernels.ops  # noqa: F401
            op = patterns.lookup_call(desc["call"])
            if op is None:
                raise SerialError(f"unknown registered call {desc['call']!r}")
            return op
        if kind in ("aten", "call"):
            target = _resolve_target(desc["target"])
            targs = tuple(decode_value(a) for a in _typed(desc["args"], list))
            tkwargs = {k: decode_value(v)
                       for k, v in _typed(desc["kwargs"], dict).items()}
            fn = _template_fn(target, targs, tkwargs)
            if kind == "aten":
                arity = sum(1 for a in pytree.tree_leaves((targs, tkwargs))
                            if isinstance(a, _In))
                return Operator(name=f"{RESIDUE_PREFIX}{_op_name(target)}]",
                                arity=arity, fn=fn, desc=desc)
            op = patterns.lookup_call(desc["call"])
            if op is None or target._schema.name != desc["call"]:
                raise SerialError(f"unknown registered call {desc['call']!r}")
            return dataclasses.replace(op, fn=fn, desc=desc)
    except (KeyError, TypeError, AttributeError) as exc:
        raise SerialError(f"malformed operator descriptor {desc!r}: {exc}") from None
    raise SerialError(f"unknown operator kind {kind!r}")


class _Lowering:
    def __init__(self, graph: Graph, strict: bool):
        self.g = graph
        self.strict = strict
        self.unmapped: list[str] = []

    def _ref(self, env: dict, atom) -> NodeRef:
        if isinstance(atom, fx.Node):
            return NodeRef(self.g, env[atom])
        return self.g.const(atom, name="lit")

    def _set_aval(self, node_id: int, val) -> None:
        self.g.nodes[node_id].aval = _spec(val)

    def lower(self, gm: fx.GraphModule, env: dict) -> Any:
        for node in gm.graph.nodes:
            if node.op == "placeholder":
                continue
            if node.op == "get_attr":
                env[node] = self.g.const(getattr(gm, node.target),
                                         name="closure_const").node_id
                continue
            if node.op == "output":
                return node.args[0]
            if node.op != "call_function":
                raise TraceError(f"unexpected fx node {node.op!r}")
            env[node] = self.lower_call(env, node)
        raise TraceError("traced graph has no output node")

    def lower_call(self, env: dict, node: fx.Node) -> int:
        target, args, kwargs = node.target, node.args, node.kwargs
        val = node.meta.get("val")

        if target is operator.getitem:             # projection of a tuple
            src, i = args
            nid = self.g.apply(_projection(i), self._ref(env, src)).node_id
            self._set_aval(nid, val)
            return nid

        name = str(target)
        refs = [self._ref(env, a) for a in _node_leaves((args, kwargs))]
        specs = [self.g.nodes[r.node_id].aval for r in refs]

        # 1. speculative branch (C4)
        if name == "aten.where.self" and not kwargs and \
                all(isinstance(a, fx.Node) for a in args):
            nid = self.g.select(*refs).node_id
            self._set_aval(nid, val)
            return nid

        # 2. registered custom op: one LARGE node
        schema = getattr(target, "_schema", None)
        call = patterns.lookup_call(schema.name) if schema is not None else None
        if call is not None:
            nid = self.g.apply(_custom_call_operator(target, args, kwargs, call),
                               *refs).node_id
            self._set_aval(nid, val)
            return nid

        # 3. primitive registry
        entry = patterns.lookup_primitive(name)
        op = None
        if isinstance(entry, Operator):
            if not kwargs and len(args) == entry.arity:
                op, refs = entry, [self._ref(env, a) for a in args]
        elif entry is not None:
            op = entry(args, kwargs, specs)
        if op is not None and op.arity == len(refs):
            nid = self.g.apply(op, *refs).node_id
            self._set_aval(nid, val)
            return nid

        # 4. unmapped: strict error or residue
        if self.strict:
            raise TraceError(
                f"aten op {name!r} has no operator-library lowering (strict "
                f"mode). Register one with patterns.register_op({name!r}, ...) "
                f"or trace with strict=False to leave it as residue. "
                f"Registered: {patterns.registered_primitives()}")
        self.unmapped.append(_op_name(target))
        nid = self.g.apply(_residue_operator(target, args, kwargs), *refs).node_id
        self._set_aval(nid, val)
        return nid


def _fake_args(args: tuple, mode: FakeTensorMode) -> tuple:
    """Fake stand-ins for the trace signature: concrete tensors are faked
    without copying, :class:`TensorSpec` leaves become empty fake tensors."""
    def leaf(a):
        if isinstance(a, torch.Tensor):
            return mode.from_tensor(a)
        if isinstance(a, TensorSpec):
            with mode:
                return torch.empty(a.shape, dtype=a.dtype,
                                   device=a.device or "cpu")
        raise TypeError(f"traced arguments must be tensors or TensorSpecs, "
                        f"got {type(a).__name__}")
    return pytree.tree_map(leaf, args)


def trace_to_graph(fn: Callable[..., Any], *args, name: str | None = None,
                   strict: bool = False) -> Lowered:
    """Capture ``fn`` at the abstract shapes of ``args`` and lower it to a
    :class:`Graph`.

    Args:
      fn: a plain PyTorch callable; arguments may be pytrees (dicts, lists,
        tuples) of tensors.
      *args: tensors or :class:`TensorSpec` pytrees fixing the signature.
      name: graph name (defaults to ``fn.__name__``).
      strict: error on aten ops without a library lowering instead of
        leaving them as residue.
    """
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    flat_fake, in_tree = pytree.tree_flatten(_fake_args(args, mode))

    out_trees = []

    def flat_fn(*flat):       # one placeholder per leaf, whatever fn's signature
        leaves, out_tree = pytree.tree_flatten(fn(*pytree.tree_unflatten(list(flat), in_tree)))
        out_trees.append(out_tree)   # the caller's containers (e.g. a dataclass)
        return leaves                # make_fx sees a flat list of tensors

    with mode:
        gm = make_fx(flat_fn, tracing_mode="real")(*flat_fake)

    g = Graph(name or getattr(fn, "__name__", None) or "traced")
    lowering = _Lowering(g, strict)
    env: dict = {}
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    for i, (node, val) in enumerate(zip(placeholders, flat_fake)):
        ref = g.input(f"arg{i}", tuple(val.shape), val.dtype, val.device)
        env[node] = ref.node_id
    # the output node holds the result's leaves in flattening order; the
    # caller's structure was recorded above
    outs, out_tree = list(lowering.lower(gm, env)), out_trees[0]
    g.output(*[lowering._ref(env, v) for v in outs])
    # every node carries its traced aval: no meta-tensor shape sweep needed
    g.seal_shapes()
    return Lowered(graph=g, out_tree=out_tree, unmapped=tuple(lowering.unmapped))
