"""Parallel-pattern operator library — the "pre-synthesized bitstream" library.

The paper's programmers compose accelerators from a library of pre-synthesized
parallel patterns (map, reduce, filter) plus scalar operators (mul, add,
sqrtf, sin, cos, log).  Each library entry is an :class:`Operator`: a named,
shape-polymorphic PyTorch callable with a *granularity class* mirroring the
paper's heterogeneous PR-tile sizes (§II):

* ``LARGE``  — occupies a large PR tile (paper: 8 DSP / 964 FF / 1228 LUT;
  here: ops worth a hand-written kernel or a matmul — transcendentals,
  reductions, the CUDA kernels of ``kernels/``).
* ``SMALL``  — packs into a small PR tile (paper: 4 DSP / 156 FF / 270 LUT;
  here: cheap elementwise ops).

Port of ``repro/core/patterns.py``: the same operator names and patterns;
the primitive registry is keyed by aten op overloads (``"aten.mul.Tensor"``)
instead of jaxpr primitive names, and the call registry by custom-op names
(``"repro_torch::rmsnorm"``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Sequence

import torch
import torch.nn.functional as F


class TileClass(enum.Enum):
    """Granularity class — which PR-tile size an operator needs (paper §II)."""

    SMALL = "small"
    LARGE = "large"


@dataclasses.dataclass(frozen=True)
class Operator:
    """One library entry — the analogue of a pre-synthesized bitstream.

    Attributes:
      name: library name (cache-key component; the paper's "symbolic link").
      arity: number of inputs.
      fn: the PyTorch computation.
      tile_class: LARGE or SMALL (heterogeneous tile sizing, paper C5).
      flops_per_elem: rough per-element FLOP cost (placement cost model).
      signature: disambiguator for operators whose behaviour is not fully
        captured by ``name`` (residue ops parameterized by their constant
        arguments) — feeds :meth:`Graph.fingerprint`.
      desc: the operator's serial form — a JSON-ready descriptor that names
        it (a library entry, a pattern over one, a cast, an aten overload or
        a registered call with its constant arguments) so a kernel built
        from it can be written to the bitstream store and rebuilt in
        another process (:func:`repro_torch.core.trace.fn_from_desc`).
        None for an operator built from an arbitrary callable: a kernel
        holding one is not persisted.
    """

    name: str
    arity: int
    fn: Callable[..., Any]
    tile_class: TileClass = TileClass.SMALL
    flops_per_elem: float = 1.0
    signature: str = ""
    desc: Any = dataclasses.field(default=None, compare=False, hash=False,
                                  repr=False)

    def __call__(self, *args):
        if len(args) != self.arity:
            raise TypeError(
                f"operator {self.name!r} expects {self.arity} inputs, got {len(args)}")
        return self.fn(*args)


class OperatorLibrary:
    """Registry of operators — the bitstream library handed to programmers."""

    def __init__(self) -> None:
        self._ops: dict[str, Operator] = {}

    def register(self, op: Operator) -> Operator:
        if op.name in self._ops:
            raise ValueError(f"operator {op.name!r} already registered")
        self._ops[op.name] = op
        return op

    def __getitem__(self, name: str) -> Operator:
        try:
            return self._ops[name]
        except KeyError:
            raise KeyError(
                f"unknown operator {name!r}; known: {sorted(self._ops)}") from None

    def __contains__(self, name: str) -> bool:
        return name in self._ops

    def names(self) -> list[str]:
        return sorted(self._ops)


LIBRARY = OperatorLibrary()


def _reg(name: str, arity: int, fn, tile_class=TileClass.SMALL, flops=1.0) -> Operator:
    return LIBRARY.register(
        Operator(name=name, arity=arity, fn=fn, tile_class=tile_class,
                 flops_per_elem=flops, desc={"k": "lib", "name": name}))


def _gelu(x):
    return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default form


# --- scalar / elementwise operators (the paper's small-tile residents) -------
ADD = _reg("add", 2, torch.add)
SUB = _reg("sub", 2, torch.sub)
MUL = _reg("mul", 2, torch.mul)
DIV = _reg("div", 2, torch.div)
MAX = _reg("max", 2, torch.maximum)
MIN = _reg("min", 2, torch.minimum)
NEG = _reg("neg", 1, torch.neg)
ABS = _reg("abs", 1, torch.abs)
RELU = _reg("relu", 1, torch.relu)
SIGMOID = _reg("sigmoid", 1, torch.sigmoid)
SILU = _reg("silu", 1, F.silu)
GELU = _reg("gelu", 1, _gelu, flops=4.0)

# --- transcendental operators (the paper's large-tile residents: §II lists
# sqrtf, sin, cos, log as the ops needing the 8-DSP tiles) --------------------
SQRT = _reg("sqrtf", 1, torch.sqrt, TileClass.LARGE, flops=4.0)
SIN = _reg("sin", 1, torch.sin, TileClass.LARGE, flops=8.0)
COS = _reg("cos", 1, torch.cos, TileClass.LARGE, flops=8.0)
LOG = _reg("log", 1, torch.log, TileClass.LARGE, flops=8.0)
EXP = _reg("exp", 1, torch.exp, TileClass.LARGE, flops=8.0)
RSQRT = _reg("rsqrt", 1, torch.rsqrt, TileClass.LARGE, flops=4.0)
TANH = _reg("tanh", 1, torch.tanh, TileClass.LARGE, flops=8.0)

# --- comparison operators (predicates feeding speculative branches, C4) ------
GT = _reg("gt", 2, torch.gt)
LT = _reg("lt", 2, torch.lt)
GE = _reg("ge", 2, torch.ge)
LE = _reg("le", 2, torch.le)
EQ = _reg("eq", 2, torch.eq)
NE = _reg("ne", 2, torch.ne)


# --- structured patterns ------------------------------------------------------
def make_map(op: Operator) -> Operator:
    """``map`` parallel pattern: lift a unary operator over a tensor."""
    if op.arity != 1:
        raise ValueError(f"map needs a unary operator, got {op.name!r} (arity {op.arity})")
    return Operator(name=f"map[{op.name}]", arity=1, fn=op.fn,
                    tile_class=op.tile_class, flops_per_elem=op.flops_per_elem,
                    desc=None if op.desc is None else {"k": "map", "op": op.desc})


def make_zip_with(op: Operator) -> Operator:
    """``zipWith`` pattern: lift a binary operator over two tensors (VMUL = zipWith mul)."""
    if op.arity != 2:
        raise ValueError(f"zip_with needs a binary operator, got {op.name!r}")
    return Operator(name=f"zip[{op.name}]", arity=2, fn=op.fn,
                    tile_class=op.tile_class, flops_per_elem=op.flops_per_elem,
                    desc=None if op.desc is None else {"k": "zip", "op": op.desc})


_REDUCERS = {"add": torch.sum, "mul": torch.prod, "max": torch.amax,
             "min": torch.amin}


def _fold(x: torch.Tensor, op: Operator, axis: "int | None") -> torch.Tensor:
    """Generic (slow) reduction over an arbitrary binary monoid."""
    if axis is None:
        x, axis = x.reshape(-1), 0
    parts = x.unbind(axis)
    acc = torch.zeros_like(parts[0]) if parts else x.new_zeros(())
    for p in parts:
        acc = op.fn(acc, p)
    return acc


def make_reduce(op: Operator, axis: "int | tuple[int, ...] | None" = None) -> Operator:
    """``reduce`` pattern over a monoid operator."""
    if op.arity != 2:
        raise ValueError(f"reduce needs a binary operator, got {op.name!r}")
    reducer = _REDUCERS.get(op.name)
    if reducer is None:
        if isinstance(axis, tuple):
            raise ValueError("generic reduce takes one axis or None")

        def fn(x, _op=op, _axis=axis):
            return _fold(x, _op, _axis)
    elif op.name == "mul":
        def fn(x, _axis=axis):
            if _axis is None:
                return torch.prod(x)
            for a in sorted(_axis if isinstance(_axis, tuple) else (_axis,),
                            reverse=True):
                x = torch.prod(x, dim=a)
            return x
    else:
        def fn(x, _r=reducer, _axis=axis):
            return _r(x) if _axis is None else _r(x, dim=_axis)
    desc = None if op.desc is None else {
        "k": "reduce", "op": op.desc,
        "axis": list(axis) if isinstance(axis, tuple) else axis}
    return Operator(name=f"reduce[{op.name},axis={axis}]", arity=1, fn=fn,
                    tile_class=TileClass.LARGE,  # accumulator-equipped tiles
                    flops_per_elem=op.flops_per_elem, desc=desc)


def make_filter(pred: Callable[[Any], Any], name: str) -> Operator:
    """``filter`` pattern with static shapes: returns ``(values, mask)``.

    FPGAs stream-compact; a GPU program with fixed shapes yields the original
    values plus a boolean mask (downstream reduces must be mask-aware)."""
    def fn(x, _p=pred):
        return x, _p(x)
    return Operator(name=f"filter[{name}]", arity=1, fn=fn, tile_class=TileClass.SMALL)


MATMUL = LIBRARY.register(
    Operator(name="matmul", arity=2,
             fn=lambda a, b: torch.matmul(a.float(), b.float()),
             tile_class=TileClass.LARGE, flops_per_elem=2.0,
             desc={"k": "lib", "name": "matmul"}))


# -----------------------------------------------------------------------------
# aten op -> Operator lowering registry (the trace frontend's dispatch table)
# -----------------------------------------------------------------------------
# ``trace.py`` captures plain PyTorch functions as aten-level fx graphs and
# consults this table to turn each aten op into a library Operator — the
# "symbolic link" resolution step.  Two entry forms:
#
#   register_op("aten.mul.Tensor", MUL)       # fixed Operator: applied to the
#                                             # op's positional args (python
#                                             # scalars become const nodes);
#                                             # declined when kwargs are given
#   @register_op("aten.sum.dim_IntList")      # rule(args, kwargs, in_specs)
#   def _rule(args, kwargs, specs): ...       #   -> Operator | None, taking the
#                                             # op's TENSOR args in order (the
#                                             # rule closes over the rest)
#
# Returning ``None`` declines the op (it falls back to residue, or errors
# under ``strict=True``).  ``kernels/ops.py`` self-registers its custom ops
# via :func:`register_call`.

LoweringRule = Callable[..., "Operator | None"]

_PRIMITIVE_TABLE: dict[str, "Operator | LoweringRule"] = {}
_CALL_TABLE: dict[str, Operator] = {}


def register_op(primitive: str, op: "Operator | LoweringRule | None" = None,
                *, override: bool = False):
    """Register a lowering for an aten op overload name (``str(overload)``)."""
    def _install(rule):
        if not override and primitive in _PRIMITIVE_TABLE:
            raise ValueError(f"primitive {primitive!r} already registered; "
                             f"pass override=True to replace")
        _PRIMITIVE_TABLE[primitive] = rule
        return rule

    if op is None:
        return _install
    return _install(op)


def unregister_op(primitive: str) -> None:
    _PRIMITIVE_TABLE.pop(primitive, None)


def lookup_primitive(primitive: str) -> "Operator | LoweringRule | None":
    return _PRIMITIVE_TABLE.get(primitive)


def registered_primitives() -> list[str]:
    return sorted(_PRIMITIVE_TABLE)


def register_call(name: str, op: Operator, *, override: bool = False) -> Operator:
    """Map a custom op (``"namespace::name"``) to one opaque Operator.

    This is how ``kernels/`` exposes its CUDA kernels to the tracer: a traced
    call to e.g. ``kernels.ops.vmul_reduce`` appears as the custom op
    ``repro_torch::vmul_reduce`` and becomes a single LARGE node — the
    pre-synthesized bitstream — instead of being decomposed."""
    if not override and name in _CALL_TABLE:
        raise ValueError(f"call {name!r} already registered")
    op = dataclasses.replace(op, desc={"k": "callop", "call": name})
    _CALL_TABLE[name] = op
    return op


def lookup_call(name: str) -> Operator | None:
    return _CALL_TABLE.get(name)


# --- default lowerings (paper §II operator inventory) ------------------------
for _prims, _lib_op in [
    (("add.Tensor",), ADD), (("sub.Tensor",), SUB), (("mul.Tensor",), MUL),
    (("div.Tensor",), DIV), (("maximum.default",), MAX),
    (("minimum.default",), MIN), (("neg.default",), NEG),
    (("abs.default",), ABS), (("relu.default",), RELU),
    (("sigmoid.default",), SIGMOID), (("silu.default",), SILU),
    (("sqrt.default",), SQRT), (("sin.default",), SIN), (("cos.default",), COS),
    (("log.default",), LOG), (("exp.default",), EXP),
    (("rsqrt.default",), RSQRT), (("tanh.default",), TANH),
    (("gt.Tensor", "gt.Scalar"), GT), (("lt.Tensor", "lt.Scalar"), LT),
    (("ge.Tensor", "ge.Scalar"), GE), (("le.Tensor", "le.Scalar"), LE),
    (("eq.Tensor", "eq.Scalar"), EQ), (("ne.Tensor", "ne.Scalar"), NE),
]:
    for _p in _prims:
        register_op(f"aten.{_p}", _lib_op)
del _prims, _lib_op, _p


def _normalize_axes(axes: Sequence[int], spec) -> "int | tuple[int, ...] | None":
    """Full-rank reductions normalize to axis=None so traced graphs carry the
    same operator names as hand-built ones (``reduce[add,axis=None]``)."""
    ndim = len(spec.shape)
    axes = tuple(sorted(a % ndim for a in axes)) if ndim else ()
    if len(axes) == ndim:
        return None
    return axes[0] if len(axes) == 1 else axes


@register_op("aten.sum.default")
def _lower_sum_all(args, kwargs, specs):
    if kwargs:                      # dtype= changes the result type
        return None
    return make_reduce(ADD, axis=None)


@register_op("aten.sum.dim_IntList")
def _lower_sum_dims(args, kwargs, specs):
    dims = args[1] if len(args) > 1 else None
    keepdim = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
    if keepdim or kwargs.get("dtype") is not None or not dims:
        return None
    return make_reduce(ADD, axis=_normalize_axes(dims, specs[0]))


@register_op("aten.mm.default")
def _lower_mm(args, kwargs, specs):
    # the library matmul accumulates/returns float32: map only f32 products
    if all(s.dtype == torch.float32 for s in specs):
        return LIBRARY["matmul"]
    return None


@register_op("aten._to_copy.default")
def _lower_cast(args, kwargs, specs):
    if set(kwargs) != {"dtype"}:    # a device/layout move is not a cast
        return None
    dt = kwargs["dtype"]
    return make_cast(dt)


def make_cast(dtype: torch.dtype) -> Operator:
    """A dtype cast (``aten._to_copy`` with only ``dtype=``)."""
    name = str(dtype).removeprefix("torch.")
    return Operator(f"cast[{name}]", 1, lambda x, _d=dtype: x.to(_d),
                    TileClass.SMALL, flops_per_elem=0.0,
                    desc={"k": "cast", "dtype": name})
