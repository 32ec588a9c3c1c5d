"""Dataflow graph of pattern instances — the "symbolic link" composition API.

The paper's programmers write source code containing *symbolic links* to
library patterns; compilation turns those links into interpreter
instructions.  Here the same role is played by a :class:`Graph`: a static
DAG whose nodes are :class:`~repro_torch.core.patterns.Operator` instances
and whose edges are tensor dataflow.  ``Graph`` is pure metadata — no tensor
is touched until the interpreter assembles it (``interpreter.py``) under a
placement (``placement.py``).

Conditional branching (paper §II, C4) is expressed with ``select`` nodes:
both branches are *speculatively* evaluated and the predicate picks the
result (``torch.where``).

Port of ``repro/core/graph.py``.  Abstract values are :class:`TensorSpec`
(shape, dtype, device), the counterpart of ``jax.ShapeDtypeStruct``; shape
inference runs operators on ``meta`` tensors instead of ``jax.eval_shape``.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Sequence

import torch

from repro_torch.core import patterns
from repro_torch.core.patterns import Operator


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Abstract tensor: what a signature and a node's aval record."""

    shape: tuple[int, ...]
    dtype: torch.dtype
    device: "torch.device | None" = None

    def meta(self) -> torch.Tensor:
        return torch.empty(self.shape, dtype=self.dtype, device="meta")


def _to_meta(v: Any) -> Any:
    if isinstance(v, TensorSpec):
        return v.meta()
    if isinstance(v, torch.Tensor):
        return torch.empty_like(v, device="meta")
    if isinstance(v, (tuple, list)):
        return type(v)(_to_meta(x) for x in v)
    if isinstance(v, dict):
        return {k: _to_meta(x) for k, x in v.items()}
    return v


def _to_spec(v: Any) -> Any:
    if isinstance(v, torch.Tensor):
        return TensorSpec(tuple(v.shape), v.dtype)
    if isinstance(v, (tuple, list)):
        return tuple(_to_spec(x) for x in v)
    return v


@dataclasses.dataclass(frozen=True)
class NodeRef:
    """Handle to a graph node's output (what user code passes around)."""

    graph: "Graph"
    node_id: int

    def __add__(self, other: "NodeRef") -> "NodeRef":
        return self.graph.apply(patterns.ADD, self, other)

    def __mul__(self, other: "NodeRef") -> "NodeRef":
        return self.graph.apply(patterns.MUL, self, other)

    def __sub__(self, other: "NodeRef") -> "NodeRef":
        return self.graph.apply(patterns.SUB, self, other)


@dataclasses.dataclass
class Node:
    node_id: int
    kind: str                      # "input" | "const" | "op" | "select"
    op: Operator | None            # for kind == "op"
    inputs: tuple[int, ...]        # node ids feeding this node
    name: str                      # display / placement name
    aval: Any = None               # TensorSpec (or tuple of them), see infer_shapes
    payload: Any = None            # const value for kind == "const"


class Graph:
    """A DAG of operator applications, built through a symbolic API.

    >>> g = Graph("dot")
    >>> a = g.input("a", (1024,), torch.float32)
    >>> b = g.input("b", (1024,), torch.float32)
    >>> s = g.apply(patterns.make_reduce(patterns.ADD), a * b)
    >>> g.output(s)
    """

    def __init__(self, name: str = "graph") -> None:
        self.name = name
        self.nodes: list[Node] = []
        self.input_ids: list[int] = []
        self.output_ids: list[int] = []
        self._shape_cache: dict[int, Any] | None = None

    # --- construction -------------------------------------------------------
    def _add(self, kind: str, op: Operator | None, inputs: Sequence[NodeRef | int],
             name: str, payload: Any = None) -> NodeRef:
        ids = tuple(i.node_id if isinstance(i, NodeRef) else int(i) for i in inputs)
        for i in ids:
            if not (0 <= i < len(self.nodes)):
                raise ValueError(f"dangling input node id {i}")
        node = Node(node_id=len(self.nodes), kind=kind, op=op, inputs=ids,
                    name=name, payload=payload)
        self.nodes.append(node)
        self._shape_cache = None
        return NodeRef(self, node.node_id)

    def input(self, name: str, shape: Sequence[int], dtype=torch.float32,
              device: "torch.device | None" = None) -> NodeRef:
        ref = self._add("input", None, (), name)
        self.nodes[ref.node_id].aval = TensorSpec(tuple(shape), dtype, device)
        self.input_ids.append(ref.node_id)
        return ref

    def input_tree(self, name: str, aval_tree: Any) -> NodeRef:
        """Pytree-valued input (e.g. a parameter dict feeding stage
        operators): ``aval_tree`` is nested dicts and lists of
        :class:`TensorSpec`."""
        ref = self._add("input", None, (), name)
        self.nodes[ref.node_id].aval = aval_tree
        self.input_ids.append(ref.node_id)
        return ref

    def const(self, value, name: str = "const") -> NodeRef:
        """A constant node.  Python scalars stay scalars (the way an aten op
        received them); anything else becomes a tensor."""
        if not isinstance(value, (bool, int, float)):
            value = torch.as_tensor(value)
        ref = self._add("const", None, (), name, payload=value)
        self.nodes[ref.node_id].aval = _to_spec(value)
        return ref

    def apply(self, op: Operator, *args: NodeRef, name: str | None = None) -> NodeRef:
        if len(args) != op.arity:
            raise TypeError(f"{op.name} expects {op.arity} args, got {len(args)}")
        return self._add("op", op, args, name or op.name)

    def select(self, pred: NodeRef, then_val: NodeRef, else_val: NodeRef,
               name: str = "select") -> NodeRef:
        """Speculative branch: both sides computed, predicate selects (C4)."""
        return self._add("select", None, (pred, then_val, else_val), name)

    def output(self, *refs: NodeRef) -> None:
        for r in refs:
            self.output_ids.append(r.node_id)

    # --- analysis -----------------------------------------------------------
    def op_nodes(self) -> list[Node]:
        return [n for n in self.nodes if n.kind in ("op", "select")]

    def toposorted(self) -> list[Node]:
        """Nodes are appended in topological order by construction."""
        return list(self.nodes)

    def edges(self) -> list[tuple[int, int]]:
        return [(src, n.node_id) for n in self.nodes for src in n.inputs]

    def input_avals(self) -> tuple:
        return tuple(self.nodes[i].aval for i in self.input_ids)

    def infer_shapes(self) -> dict[int, Any]:
        """Abstract-evaluate every node on ``meta`` tensors (no FLOPs).

        Memoized until the graph is next mutated."""
        if self._shape_cache is not None:
            return self._shape_cache
        avals: dict[int, Any] = {}
        for n in self.nodes:
            if n.kind in ("input", "const"):
                avals[n.node_id] = n.aval
            elif n.kind == "op":
                out = n.op.fn(*(_to_meta(avals[i]) for i in n.inputs))
                avals[n.node_id] = _to_spec(out)
            elif n.kind == "select":
                _, t, e = n.inputs
                ta, ea = avals[t], avals[e]
                if (ta.shape, ta.dtype) != (ea.shape, ea.dtype):
                    raise TypeError(f"select branches disagree: {ta} vs {ea}")
                avals[n.node_id] = ta
            n.aval = avals[n.node_id]
        self._shape_cache = avals
        return avals

    def seal_shapes(self) -> None:
        """Adopt externally-recorded node avals as the shape cache (the
        tracer already knows every node's output shape)."""
        missing = [n.node_id for n in self.nodes if n.aval is None]
        if missing:
            raise ValueError(f"seal_shapes: nodes without avals: {missing[:5]}")
        self._shape_cache = {n.node_id: n.aval for n in self.nodes}

    def validate(self) -> None:
        if not self.output_ids:
            raise ValueError(f"graph {self.name!r} has no outputs")
        self.infer_shapes()

    def fingerprint(self) -> str:
        """Content hash of the graph: structure, operator identities, and
        const payloads.  Two graphs with the same name and input signature
        but different baked-in constants are *different bitstreams* — the
        cache keys on this."""
        h = hashlib.sha256()
        for n in self.nodes:
            op_id = (n.op.name, n.op.signature) if n.op is not None else None
            h.update(repr((n.kind, n.inputs, op_id)).encode())
            if n.kind == "const":
                pay = n.payload
                if isinstance(pay, torch.Tensor):
                    h.update(repr((tuple(pay.shape), str(pay.dtype))).encode())
                    flat = pay.detach().reshape(-1)
                    if flat.numel() > (1 << 18):
                        # cap hashing cost on huge constants: a strided
                        # sample, the tail, and a checksum of the rest
                        stride = max(1, flat.numel() // (1 << 16))
                        flat = torch.cat([flat[::stride], flat[-1024:],
                                          flat.float().sum().reshape(1).to(flat.dtype)])
                    h.update(flat.cpu().contiguous().view(torch.uint8).numpy().tobytes())
                else:
                    h.update(repr(pay).encode())
        h.update(repr(tuple(self.output_ids)).encode())
        return h.hexdigest()[:16]

    # --- direct (un-assembled) evaluation: the correctness oracle ------------
    def evaluate(self, *inputs) -> Any:
        """Reference evaluation in graph order, bypassing placement/ISA.

        Used by tests as the oracle the assembled accelerator must match.
        """
        if len(inputs) != len(self.input_ids):
            raise TypeError(
                f"graph {self.name!r} takes {len(self.input_ids)} inputs, "
                f"got {len(inputs)}")
        vals: dict[int, Any] = dict(zip(self.input_ids, inputs))
        for n in self.nodes:
            if n.kind == "const":
                vals[n.node_id] = n.payload
            elif n.kind == "op":
                vals[n.node_id] = n.op.fn(*(vals[i] for i in n.inputs))
            elif n.kind == "select":
                p, t, e = (vals[i] for i in n.inputs)
                vals[n.node_id] = torch.where(p, t, e)
        outs = tuple(vals[i] for i in self.output_ids)
        return outs[0] if len(outs) == 1 else outs


# --- canned graphs ------------------------------------------------------------
def vmul_reduce_graph(n: int, dtype=torch.float32) -> Graph:
    """The paper's evaluation workload: ``sum = Σ A⃗·B⃗`` (VMUL + Reduce, §III)."""
    g = Graph("vmul_reduce")
    a = g.input("A", (n,), dtype)
    b = g.input("B", (n,), dtype)
    prod = g.apply(patterns.make_zip_with(patterns.MUL), a, b, name="VMUL")
    total = g.apply(patterns.make_reduce(patterns.ADD), prod, name="Reduce")
    g.output(total)
    return g


def saxpy_graph(n: int, alpha: float = 2.0, dtype=torch.float32) -> Graph:
    g = Graph("saxpy")
    x = g.input("x", (n,), dtype)
    y = g.input("y", (n,), dtype)
    a = g.const(torch.tensor(alpha, dtype=dtype), "alpha")
    ax = g.apply(patterns.MUL, a, x, name="scale")
    g.output(g.apply(patterns.ADD, ax, y, name="axpy"))
    return g


def branchy_graph(n: int, dtype=torch.float32) -> Graph:
    """if mean(x) > 0 then sqrt(|x|) else sin(x) — exercises speculation (C4)."""
    g = Graph("branchy")
    x = g.input("x", (n,), dtype)
    mean = g.apply(patterns.make_reduce(patterns.ADD), x, name="sum")
    zero = g.const(torch.zeros((), dtype=dtype))
    pred = g.apply(patterns.GT, mean, zero, name="pred")
    then_v = g.apply(patterns.SQRT, g.apply(patterns.ABS, x), name="then")
    else_v = g.apply(patterns.SIN, x, name="else")
    g.output(g.select(pred, then_v, else_v))
    return g
