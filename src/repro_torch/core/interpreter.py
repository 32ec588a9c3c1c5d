"""Runtime interpreter — executes controller programs and assembles accelerators.

Two execution modes, mirroring the paper's runtime:

1. **Eager ISA interpretation** (:func:`run_program`) — instruction-by-
   instruction execution with a register file, stack, and hop accounting.
   This is the debugging/verification mode (and an oracle the assembled
   accelerator is tested against).

2. **JIT assembly** (:func:`assemble`) — the interpreter walks the graph
   once and *builds* the accelerator: a :class:`Kernel` holding the graph as
   a flat, slot-indexed step list.  Interconnect becomes physical data
   movement: every pass-through tile an edge crosses is one full copy pass
   over the data (``h - 1`` copies for an ``h``-hop edge, as the
   reference's ``_dyn_barrier_hops`` at ``repro/core/interpreter.py:206-221``).
   PyTorch runs eagerly and fuses nothing, so nothing elides those copies;
   a copy is exact, so outputs are bit-identical across placements.

Relocatable bitstreams: the kernel is *placement-invariant* — it takes the
per-edge hop counts as a runtime ``routes`` vector (:func:`route_vector`),
so ONE kernel serves every placement of a graph.  Moving a resident to new
tiles re-emits only the routes vector (and the controller route program).

Tiered route specialization: :func:`specialize_kernel` is the same walk
with every edge's hop count a Python int baked in at build time — the
route-constant body, valid for one hop vector.  On the card the overlay
captures that walk once as a CUDA graph (:class:`GraphKernel`) and replays
it on every dispatch: the port's form of the reference's compiled
route-constant executable.  Each walk issues its aten ops one at a time
from Python; a replay issues them all in one graph launch.

Donation: a kernel built with ``donate_argnums`` (the kernel's calling
convention, argument 0 being the routes vector) may write each output into
the storage of a donated input of the same shape and dtype (the pairing
:func:`donation_aliases` derives, JAX's rule) and returns that input in its
place — the reference's ``jax.jit(donate_argnums=)`` lets XLA do the same.
The walk writes an output back as soon as its input has been read for the
last time, so a traced train step holds one copy of its state, not two.

A kernel has a serial form (:meth:`Kernel.serial_form` /
:meth:`Kernel.from_serial`): its step list with each operator named by its
descriptor, which the bitstream store writes and a later process rebuilds
without running anything it reads.  :func:`kernel_builds` counts the
kernels a process built and loaded.

Sharded mode (:func:`assemble_sharded`): every tile is a rank of one axis
of a ``DeviceMesh`` and each hop is a real transfer to the next rank.  An
edge of ``h`` hops is ``h`` forward ring shifts by one rank along the
axis's process group, then one return shift by ``h mod n`` (the reference's
``ppermute`` ring at ``repro/core/interpreter.py:224-249``), so downstream
ops see position-independent data.  Every rank runs the walk SPMD on
replicated inputs and returns the same output, equal to the local walk's.
A shift is one ``dist.all_to_all_single`` with a single non-zero split:
gloo and NCCL both take it at any world size, a world of one included,
where torch refuses a send to one's own rank.  The store keeps no sharded
kernel: its hops name a process group.

Port of ``repro/core/interpreter.py``: the local mode, both tiers, and the
sharded mode.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import threading
import weakref
from functools import partial
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro_torch.core.graph import Graph
from repro_torch.core.isa import Opcode, Program, compile_graph
from repro_torch.core.placement import Placement


# --------------------------------------------------------------------------
# Mode 1: eager ISA interpretation
# --------------------------------------------------------------------------
@dataclasses.dataclass
class MachineState:
    regs: dict[int, Any]
    stack: list[Any]
    hops: int = 0
    bypasses: int = 0
    executed: int = 0


_ROUTE_OPS = {
    Opcode.ROUTE_N_OUT, Opcode.ROUTE_E_OUT, Opcode.ROUTE_S_OUT, Opcode.ROUTE_W_OUT,
    Opcode.ROUTE_N_IN, Opcode.ROUTE_E_IN, Opcode.ROUTE_S_IN, Opcode.ROUTE_W_IN,
}
_BYPASS_OPS = {
    Opcode.BYPASS_NS, Opcode.BYPASS_SN, Opcode.BYPASS_EW, Opcode.BYPASS_WE,
    Opcode.BYPASS_NE, Opcode.BYPASS_NW, Opcode.BYPASS_SE, Opcode.BYPASS_SW,
}


def run_program(program: Program, graph: Graph, inputs: tuple, *,
                return_state: bool = False):
    """Execute a compiled program eagerly, one instruction at a time."""
    if len(inputs) != len(graph.input_ids):
        raise TypeError(f"expected {len(graph.input_ids)} inputs, got {len(inputs)}")
    st = MachineState(regs={}, stack=[])
    in_iter = iter(zip(graph.input_ids, inputs))
    nodes = {n.node_id: n for n in graph.toposorted()}
    outputs: list[Any] = []

    for ins in program.instructions:
        op = ins.opcode
        if op is Opcode.LD_STREAM:
            nid, val = next(in_iter)
            if nid != ins.dst:
                raise RuntimeError("input order mismatch")
            st.regs[nid] = val
        elif op is Opcode.LD_CONST:
            st.regs[ins.dst] = nodes[ins.dst].payload
        elif op in _ROUTE_OPS:
            st.hops += 1
        elif op in _BYPASS_OPS:
            st.bypasses += 1
        elif op in (Opcode.VEXEC, Opcode.VEXEC_ACC):
            node = nodes[ins.dst]
            st.regs[ins.dst] = node.op.fn(*(st.regs[s] for s in ins.srcs))
            st.executed += 1
        elif op is Opcode.SELECT:
            p, t, e = (st.regs[s] for s in ins.srcs)
            st.regs[ins.dst] = torch.where(p, t, e)
            st.executed += 1
        elif op is Opcode.ST_STREAM:
            outputs.append(st.regs[ins.srcs[0]])
        elif op is Opcode.PUSH:
            st.stack.append(st.regs[ins.srcs[0]])
        elif op is Opcode.POP:
            st.regs[ins.dst] = st.stack.pop()
        elif op is Opcode.MOV:
            st.regs[ins.dst] = st.regs[ins.srcs[0]]
        # LD_TILE / SET_REG / SPEC_* / BARRIER / FENCE / LD_INSTR: operands
        # already sit in the register file; the rest are placement-time only

    result = tuple(outputs)
    result = result[0] if len(result) == 1 else result
    return (result, st) if return_state else result


# --------------------------------------------------------------------------
# Mode 2: JIT assembly
# --------------------------------------------------------------------------
def edge_order(graph: Graph) -> list[tuple[int, int]]:
    """Canonical (src, dst) order of every dataflow edge — the index space
    of the ``routes`` vector.  Depends only on the graph, never on a
    placement."""
    return graph.edges()


def route_hops(graph: Graph, placement: Placement) -> tuple[int, ...]:
    """Manhattan hop count per edge, in :func:`edge_order` order."""
    hops = placement.edge_hops
    return tuple(int(hops.get(e, 0)) for e in edge_order(graph))


def zero_hop(hops: "tuple[int, ...]") -> bool:
    """Whether a hop vector implies NO pass-through work: every edge is
    co-located (0) or nearest-neighbour (1), so the walk makes no copy
    pass.  This is the contiguous steady state ``defragment()`` produces."""
    return all(int(h) <= 1 for h in hops)


def route_vector(graph: Graph, placement: Placement) -> torch.Tensor:
    """The per-placement route program's data half: an int32 vector of hop
    counts, one per edge.  This — not the kernel — is all that changes when
    a resident moves.  It lives on the host: the kernel walk reads it once
    per call to decide how many copy passes each edge makes."""
    return torch.tensor(route_hops(graph, placement), dtype=torch.int32)


def _copy_pass(t: torch.Tensor) -> torch.Tensor:
    """One copy of ``t`` into fresh memory with the SAME layout: identical
    sizes and strides, and the storage offset kept modulo 256 bytes, so the
    address alignment matches as far as the allocator aligns (512 bytes for
    CUDA memory).  The copy covers the span of memory ``t`` views, so
    strided, sliced and broadcast views come out as the same views.  A
    layout change could steer a later kernel (a cuBLAS algorithm, a
    vectorized path) to another summation order, and the overlay promises
    bit-identical results across placements and against plain execution."""
    if t.numel() == 0:
        return t.clone()
    span = 1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
    pad = t.storage_offset() % max(1, 256 // t.element_size())
    raw = torch.empty(pad + span, dtype=t.dtype, device=t.device)
    raw[pad:].copy_(t.as_strided((span,), (1,), t.storage_offset()))
    return raw.as_strided(t.shape, t.stride(), pad)


def copy_passes(v: Any, passes: int) -> Any:
    """``passes`` full copy passes over ``v`` — one per pass-through tile.
    An FPGA pass-through tile registers and forwards the stream: one pass
    over the data with no compute.  Tuples (multi-result residue) cross the
    tile as a bundle; scalars carry no data."""
    if isinstance(v, torch.Tensor):
        for _ in range(passes):
            v = _copy_pass(v)
        return v
    if isinstance(v, tuple):
        return tuple(copy_passes(x, passes) for x in v)
    return v


def local_hop(v: Any, h: int) -> Any:
    """The local mode's hop: an edge of ``h`` hops crosses ``h - 1``
    pass-through tiles, each one copy pass (:func:`copy_passes`)."""
    return copy_passes(v, h - 1) if h >= 2 else v


def _ring_shift(v: Any, group: Any, k: int) -> Any:
    """``v`` moved ``k`` ranks along ``group``'s ring (rank r's value lands
    on rank r + k): one ``dist.all_to_all_single`` of the bytes of the
    memory span a tensor views, every split zero but the one to r + k, into
    fresh memory of the same layout (:func:`_copy_pass`'s).  Tuples move as
    a bundle, one shift a tensor; scalars carry no data."""
    if isinstance(v, tuple):
        return tuple(_ring_shift(x, group, k) for x in v)
    if not isinstance(v, torch.Tensor):
        return v
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    span = 1 + sum((m - 1) * st for m, st in zip(v.shape, v.stride())) if v.numel() else 0
    pad = v.storage_offset() % max(1, 256 // v.element_size())
    raw = torch.empty(pad + span, dtype=v.dtype, device=v.device)
    src = v.as_strided((span,), (1,), v.storage_offset()).view(torch.uint8)
    nbytes = span * v.element_size()
    out_splits, in_splits = [0] * n, [0] * n
    in_splits[(r + k) % n] = nbytes
    out_splits[(r - k) % n] = nbytes
    dist.all_to_all_single(raw[pad:].view(torch.uint8), src, out_splits, in_splits,
                           group=group)
    return raw.as_strided(v.shape, v.stride(), pad)


def ring_hops(group: Any) -> Callable[[Any, int], Any]:
    """The sharded mode's hop: ``hop(v, h)`` moves ``v`` ``h`` forward
    shifts by one rank (the pass-through latency actually paid), then one
    return shift by ``h mod n`` back to its origin, as the reference's
    ``_dyn_ici_hops`` and ``_static_ici_hops``.  ``h`` is 0 for a
    co-located edge: nothing moves."""
    n = dist.get_world_size(group)

    def hop(v: Any, h: int) -> Any:
        for _ in range(h):
            v = _ring_shift(v, group, 1)
        if h % n:
            v = _ring_shift(v, group, -(h % n))
        return v

    return hop


def _aval_key(aval: Any) -> "tuple | None":
    """What a donated input and an output must share to alias: shape and
    dtype (a traced graph records no device on op outputs)."""
    if hasattr(aval, "shape") and hasattr(aval, "dtype"):
        return (tuple(aval.shape), aval.dtype)
    return None


def donation_aliases(graph: Graph, donated: "tuple[int, ...]"
                     ) -> "tuple[tuple[int, int], ...]":
    """``(output position, input position)`` pairs for the donated input
    positions ``donated``: each output, in order, takes the first donated
    input of its shape and dtype not yet taken (the rule JAX applies to
    ``donate_argnums``).  A donated input that the graph also returns as an
    output keeps its storage and aliases nothing."""
    outs = set(graph.output_ids)
    pool: dict[Any, list[int]] = {}
    for pos in sorted(set(donated)):
        nid = graph.input_ids[pos]
        key = _aval_key(graph.nodes[nid].aval)
        if nid not in outs and key is not None:
            pool.setdefault(key, []).append(pos)
    pairs = []
    for o, nid in enumerate(graph.output_ids):
        free = pool.get(_aval_key(graph.nodes[nid].aval))
        if free:
            pairs.append((o, free.pop(0)))
    return tuple(pairs)


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def donation_targets(inputs: tuple, aliases) -> "list[tuple[int, int]]":
    """The pairs of ``aliases`` this call can honor: the donated input is a
    tensor with data whose storage no other input shares (a tensor passed
    twice, or viewed by another argument, is read after the write)."""
    if not aliases:
        return []
    seen: dict[int, int] = {}
    for x in inputs:
        if isinstance(x, torch.Tensor) and x.numel():
            ptr = _storage(x)
            seen[ptr] = seen.get(ptr, 0) + 1
    return [(o, i) for o, i in aliases
            if isinstance(inputs[i], torch.Tensor) and inputs[i].numel()
            and seen[_storage(inputs[i])] == 1]


def write_back(x: torch.Tensor, y: Any) -> torch.Tensor:
    """Land output ``y`` in donated input ``x``'s storage; returns ``x``."""
    if y is not x:
        if isinstance(y, torch.Tensor) and y.numel() and _storage(y) == _storage(x):
            y = y.clone()                  # a view of x: read it before the write
        with torch.no_grad():
            x.copy_(y)
    return x


@dataclasses.dataclass(frozen=True)
class _Step:
    node_id: int
    fn: Callable[..., Any] | None        # None: select
    srcs: tuple[tuple[int, int], ...]    # (source slot, edge index)
    frees: tuple[int, ...] = ()          # slots no later step reads
    desc: Any = None                     # the operator's serial form


class Kernel:
    """The placement-invariant compute body: ``kernel(routes, *inputs)``.

    Built once per graph (this is what a bitstream *download* produces in
    the port, and what the cache holds): the graph flattened into a step
    list over value slots, each step naming its operator and, per input,
    the source slot and the edge whose hop count the runtime ``routes``
    vector supplies.  One kernel is valid for *every* placement of the
    graph — relocation swaps the routes vector, the kernel stays.  Each
    step drops the values it read last (and an unread result of its own),
    so a walk holds only live values, as eager execution does: a traced
    train step's activations and optimizer temporaries would not fit on the
    card otherwise.

    An edge of ``h >= 1`` hops is ``hop_fn(v, h)``: :func:`local_hop`'s
    copy passes, or :func:`ring_hops`'s shifts in a sharded kernel."""

    hop_fn = staticmethod(local_hop)   # a kernel rebuilt from its serial form is local

    def __init__(self, graph: Graph, donate_argnums: "tuple[int, ...]" = (),
                 hop_fn: "Callable[[Any, int], Any]" = local_hop) -> None:
        order = edge_order(graph)
        # an op reading one value twice (x * x) has the edge twice; both
        # entries carry the same hop count, so either index serves
        eidx = {e: i for i, e in enumerate(order)}
        self.name = graph.name
        self.num_edges = len(order)
        self.num_slots = len(graph.nodes)
        self.input_ids = tuple(graph.input_ids)
        self.output_ids = tuple(graph.output_ids)
        self.consts = tuple((n.node_id, n.payload) for n in graph.nodes
                            if n.kind == "const")
        steps = [_Step(n.node_id, n.op.fn if n.kind == "op" else None,
                       tuple((s, eidx[(s, n.node_id)]) for s in n.inputs),
                       desc=n.op.desc if n.kind == "op" else None)
                 for n in graph.toposorted() if n.kind in ("op", "select")]
        last = {step.node_id: i for i, step in enumerate(steps)}
        for i, step in enumerate(steps):
            for src, _ in step.srcs:
                last[src] = i
        frees: list[list[int]] = [[] for _ in steps]
        for slot, i in last.items():
            if slot not in self.output_ids:
                frees[i].append(slot)
        self.steps = tuple(dataclasses.replace(step, frees=tuple(f))
                           for step, f in zip(steps, frees))
        self.donate_argnums = tuple(sorted(set(donate_argnums)))
        if any(not 1 <= a <= len(self.input_ids) for a in self.donate_argnums):
            raise ValueError(f"kernel {self.name!r}: donate_argnums "
                             f"{self.donate_argnums} outside inputs 1..{len(self.input_ids)}")
        self.aliases = donation_aliases(graph, tuple(a - 1 for a in self.donate_argnums))
        self.hop_fn = hop_fn
        _count_build(type(self).__name__)

    # -- serial form (the bitstream store's payload) -------------------------
    def serial_form(self) -> "tuple[dict, list]":
        """The kernel as a JSON-ready step list, plus its const payloads (in
        ``program["consts"]`` order) for ``torch.save``.  Every operator is
        named by its descriptor (:attr:`~repro_torch.core.patterns.Operator.desc`)
        in the program's ``ops`` table, which steps index; raises :class:`~repro_torch.core.trace.SerialError` when one has
        none."""
        from repro_torch.core.trace import SerialError

        if self.hop_fn is not local_hop:
            raise SerialError(f"kernel {self.name!r} is sharded: its hops name a "
                              f"process group")
        # each distinct operator once (a 32-layer step repeats each of its
        # few dozen operators once a layer); a step names it by index
        ops: dict[str, int] = {}
        steps = []
        for st in self.steps:
            if st.fn is not None and st.desc is None:
                raise SerialError(f"kernel {self.name!r}: node {st.node_id} "
                                  f"has an operator with no serial form")
            op = None
            if st.desc is not None:
                op = ops.setdefault(json.dumps(st.desc, sort_keys=True), len(ops))
            steps.append([st.node_id, op, [list(s) for s in st.srcs],
                          list(st.frees)])
        program = {"name": self.name, "num_edges": self.num_edges,
                   "num_slots": self.num_slots,
                   "input_ids": list(self.input_ids),
                   "output_ids": list(self.output_ids),
                   "ops": [json.loads(text) for text in ops],
                   "consts": [nid for nid, _ in self.consts], "steps": steps,
                   "hops": list(self.hops) if isinstance(self, SpecializedKernel)
                   else None,
                   "donate_argnums": list(self.donate_argnums),
                   "aliases": [list(pair) for pair in self.aliases]}
        return program, [payload for _, payload in self.consts]

    @staticmethod
    def from_serial(program: dict, consts: list) -> "Kernel":
        """Rebuild a kernel (a :class:`SpecializedKernel` when the program
        carries hops) from :meth:`serial_form`'s output, resolving each
        operator by name.  Raises :class:`~repro_torch.core.trace.SerialError`
        on anything malformed or unresolvable; runs no code it reads."""
        from repro_torch.core.trace import SerialError, operator_from_desc

        try:
            hops = program["hops"]
            kernel = Kernel.__new__(SpecializedKernel if hops is not None else Kernel)
            kernel.name = str(program["name"])
            kernel.num_edges = _nat(program["num_edges"])
            kernel.num_slots = _nat(program["num_slots"])
            kernel.input_ids = _indices(program["input_ids"], kernel.num_slots)
            kernel.output_ids = _indices(program["output_ids"], kernel.num_slots)
            const_ids = _indices(program["consts"], kernel.num_slots)
            if len(const_ids) != len(consts):
                raise SerialError("const table and payloads disagree")
            kernel.consts = tuple(zip(const_ids, consts))
            descs = list(program["ops"])
            fns = [operator_from_desc(d).fn for d in descs]
            # the step table: indices checked in bulk, not one by one
            raw = program["steps"]
            ops = _indices([op for _, op, _, _ in raw if op is not None], len(fns))
            srcs = [tuple(map(tuple, s)) for _, _, s, _ in raw]
            pairs = [pair for s in srcs for pair in s]
            if any(len(pair) != 2 for pair in pairs):
                raise SerialError("a step source is not a (slot, edge) pair")
            _indices([nid for nid, _, _, _ in raw] + [sl for sl, _ in pairs]
                     + [f for _, _, _, fr in raw for f in fr], kernel.num_slots)
            _indices([e for _, e in pairs], kernel.num_edges)
            ops = iter(ops)
            steps = []
            for (nid, op, _, frees), src in zip(raw, srcs):
                if op is None:
                    steps.append(_Step(nid, None, src, tuple(frees)))
                else:
                    op = next(ops)
                    steps.append(_Step(nid, fns[op], src, tuple(frees), desc=descs[op]))
            kernel.steps = tuple(steps)
            if hops is not None:
                kernel.hops = tuple(_nat(h) for h in hops)
                if len(kernel.hops) != kernel.num_edges:
                    raise SerialError("hop vector and edge count disagree")
            n_in = len(kernel.input_ids)
            # a program written before donation existed has neither key
            kernel.donate_argnums = _indices(program.get("donate_argnums", []), n_in + 1)
            if 0 in kernel.donate_argnums:
                raise SerialError("the routes argument is never donated")
            pairs = [tuple(p) for p in program.get("aliases", [])]
            if any(len(p) != 2 for p in pairs):
                raise SerialError("an alias is not an (output, input) pair")
            outs = _indices([o for o, _ in pairs], len(kernel.output_ids))
            ins = _indices([i for _, i in pairs], n_in)
            if len(set(outs)) != len(pairs) or len(set(ins)) != len(pairs) \
                    or not {i + 1 for i in ins} <= set(kernel.donate_argnums):
                raise SerialError("aliases must pair distinct outputs with "
                                  "distinct donated inputs")
            kernel.aliases = tuple(pairs)
        except SerialError:
            raise
        except (KeyError, TypeError, ValueError) as exc:
            raise SerialError(f"malformed kernel program: {exc!r}") from None
        _count_build("loaded")
        return kernel

    def __call__(self, routes: torch.Tensor, *inputs):
        hops = routes.tolist()
        if len(hops) != self.num_edges or len(inputs) != len(self.input_ids):
            raise TypeError(
                f"kernel {self.name!r} takes {self.num_edges} routes and "
                f"{len(self.input_ids)} inputs, got {len(hops)} and {len(inputs)}")
        return self._walk(hops, inputs)

    def _walk(self, hops, inputs, donate: bool = True):
        vals: list[Any] = [None] * self.num_slots
        for nid, x in zip(self.input_ids, inputs):
            vals[nid] = x
        for nid, payload in self.consts:
            vals[nid] = payload
        landing = _Landing(self, inputs, vals) if donate and self.aliases else None
        hop_fn = self.hop_fn
        for n, step in enumerate(self.steps):
            args = []
            for src, e in step.srcs:
                v = vals[src]
                if hops[e]:
                    v = hop_fn(v, hops[e])
                args.append(v)
            if step.fn is not None:
                vals[step.node_id] = step.fn(*args)
            else:
                p, t, f = args
                vals[step.node_id] = torch.where(p, t, f)
            if landing is not None:
                landing.after(n, step.node_id)
            for slot in step.frees:
                vals[slot] = None
        outs = tuple(vals[i] for i in self.output_ids)
        return outs[0] if len(outs) == 1 else outs

    @functools.cached_property
    def _donation_plan(self) -> "tuple[dict[int, int], dict[int, int]]":
        """Per slot, the index of the step that reads it last and of the
        step that produces it (-1: an input or a const)."""
        last: dict[int, int] = {}
        made: dict[int, int] = {}
        for i, step in enumerate(self.steps):
            made[step.node_id] = i
            for src, _ in step.srcs:
                last[src] = i
        return last, made


class _Landing:
    """One donated walk's write-backs: each aliased output lands in its
    donated input's storage as soon as nothing reads that input any more —
    after the input slot's last reader, after the last reader of every
    value found to view its storage (a view op's result), and never while
    an output views it (that pair is then not honored).  The inputs the
    call cannot donate are left alone (:func:`donation_targets`)."""

    def __init__(self, kernel: Kernel, inputs: tuple, vals: list) -> None:
        self.last, self.made = kernel._donation_plan
        self.end = len(kernel.steps)
        self.outputs = set(kernel.output_ids)
        self.output_ids = kernel.output_ids
        self.inputs, self.vals = inputs, vals
        self.pairs = donation_targets(inputs, kernel.aliases)
        self.owner = {_storage(inputs[i]): k for k, (_, i) in enumerate(self.pairs)}
        self.ready = [self.free_after(kernel.input_ids[i]) for _, i in self.pairs]
        self.pending: dict[int, list[int]] = {}
        for k in range(len(self.pairs)):
            self.pending.setdefault(self.due(k), []).append(k)
        self.land(-1)

    def free_after(self, slot: int) -> int:
        return self.end if slot in self.outputs else self.last.get(slot, -1)

    def due(self, k: int) -> int:
        return max(self.ready[k], self.made.get(self.output_ids[self.pairs[k][0]], -1))

    def after(self, n: int, slot: int) -> None:
        """Step ``n`` produced ``slot``: note a view of a donated input,
        then land what is due."""
        if self.owner:
            out = self.vals[slot]
            for t in (out if isinstance(out, tuple) else (out,)):
                if isinstance(t, torch.Tensor) and t.numel():
                    k = self.owner.get(_storage(t))
                    if k is not None:
                        self.ready[k] = max(self.ready[k], self.free_after(slot))
        self.land(n)

    def land(self, at: int) -> None:
        for k in self.pending.pop(at, ()):
            if self.due(k) != at:              # a view found meanwhile moved it
                self.pending.setdefault(self.due(k), []).append(k)
                continue
            o, i = self.pairs[k]
            slot = self.output_ids[o]
            self.vals[slot] = write_back(self.inputs[i], self.vals[slot])
            self.owner.pop(_storage(self.inputs[i]), None)


def _nat(v, bound: "int | None" = None) -> int:
    """A non-negative int from a serial program (below ``bound`` if given)."""
    if isinstance(v, bool) or not isinstance(v, int) or v < 0 \
            or (bound is not None and v >= bound):
        raise ValueError(f"bad index {v!r}")
    return v


def _indices(values: list, bound: int) -> tuple:
    """``values`` as a tuple, each an int in ``[0, bound)``, or ValueError."""
    values = tuple(values)
    if not set(map(type, values)) <= {int} \
            or values and (min(values) < 0 or max(values) >= bound):
        raise ValueError(f"bad index among {len(values)} (bound {bound})")
    return values


# Kernels made in this process, by how: "Kernel" (built from a graph: a
# download), "SpecializedKernel" (a route-constant build) and "loaded"
# (rebuilt from the bitstream store).  A warm boot builds none.
_builds: dict[str, int] = {}
_builds_lock = threading.Lock()


def _count_build(how: str) -> None:
    with _builds_lock:
        _builds[how] = _builds.get(how, 0) + 1


def kernel_builds() -> dict[str, int]:
    """How many kernels this process built from graphs (``"Kernel"``,
    ``"SpecializedKernel"``) and rebuilt from the store (``"loaded"``)."""
    with _builds_lock:
        return dict(_builds)


def build_kernel(graph: Graph, donate_argnums: "tuple[int, ...]" = (),
                 hop_fn: "Callable[[Any, int], Any]" = local_hop) -> Kernel:
    """The placement-invariant compute body of ``graph`` (a download);
    ``donate_argnums`` in the kernel's calling convention
    (:func:`~repro_torch.core.cache.kernel_jit_kwargs`); ``hop_fn`` for the
    sharded mode (:func:`ring_hops`)."""
    graph.validate()
    return Kernel(graph, donate_argnums, hop_fn)


class SpecializedKernel(Kernel):
    """The route-CONSTANT compute body: :class:`Kernel`'s walk and calling
    convention (``kernel(routes, *inputs)``), with the hop vector baked in
    at build time.  No hop count is read from the runtime ``routes``
    argument (the generic walk's ``routes.tolist()`` is gone), so the walk
    reads nothing on the host and can be captured as a CUDA graph."""

    def __init__(self, graph: Graph, hops: "tuple[int, ...]",
                 donate_argnums: "tuple[int, ...]" = (),
                 hop_fn: "Callable[[Any, int], Any]" = local_hop) -> None:
        super().__init__(graph, donate_argnums, hop_fn)
        if len(hops) != self.num_edges:
            raise ValueError(
                f"hop vector has {len(hops)} entries for {self.num_edges} edges")
        self.hops = tuple(int(h) for h in hops)

    def __call__(self, routes: Any, *inputs):
        if len(inputs) != len(self.input_ids):
            raise TypeError(f"kernel {self.name!r} takes {len(self.input_ids)} "
                            f"inputs, got {len(inputs)}")
        return self._walk(self.hops, inputs)


def specialize_kernel(graph: Graph, hops: "tuple[int, ...]",
                      donate_argnums: "tuple[int, ...]" = (),
                      hop_fn: "Callable[[Any, int], Any]" = local_hop) -> SpecializedKernel:
    """The route-constant body of ``graph`` for one hop vector
    (:func:`route_hops`) — the specialized artifact tier.  Edges with
    ``h >= 2`` keep their ``h - 1`` copy passes (the pass-through cost
    model), the rest vanish, exactly as in the generic walk, so the two are
    bit-identical.  The reference also guards contraction-prone edges with
    an opaque exact 1.0 (``_contraction_guard_needed``): XLA fuses across
    the edges of its route-constant body and LLVM could form FMAs there.
    Eager PyTorch runs each op on its own and fuses nothing, so the port
    needs no guard.  With ``hop_fn`` (the sharded mode) each edge of ``h``
    hops keeps its ``h`` forward shifts and one return shift."""
    graph.validate()
    return SpecializedKernel(graph, hops, donate_argnums, hop_fn)


@functools.cache
def _capture_stream(device_index: int) -> "torch.cuda.Stream":
    """The side stream every capture on a device runs on.  One per device:
    PyTorch keeps a cuBLAS workspace (32 MiB on an H100) for each stream that
    ran a cuBLAS call, for the life of the process, so a stream per capture
    would leak one workspace per specialization."""
    return torch.cuda.Stream(device=device_index)


# captures share their device's side stream: one at a time per process
_capture_lock = threading.Lock()


class GraphKernel:
    """A route-constant walk captured once as a ``torch.cuda.CUDAGraph``
    and replayed on every call — the specialized artifact on the card.

    Built from example inputs, on the thread that asks for the tier (the
    serving thread on a synchronous overlay, a scheduler worker on an
    asynchronous one, while the serving thread keeps launching work):

    * the inputs' versions are read, then each input is copied into a
      private static buffer of the same layout on the calling thread's
      current stream (the device's default stream on a worker, which is
      also the serving thread's unless it switched): the copies see every
      write issued there before them, and a write after the version read
      makes the next call copy that input again;
    * one eager warm-up walk on the capture stream, after it waits for the
      copies (it builds and opts in every kernel, allocates per-stream
      workspaces and starts cuBLAS there);
    * the capture, in ``"thread_local"`` error mode: CUDA then forbids
      unsafe calls (a synchronize, an event query) only on the capturing
      thread, so the serving thread's allocations and its device-to-host
      copies go on.  The capture's launches are booked on this thread's
      record (:func:`~repro_torch.kernels.native.recording_launches`), so
      launches the serving thread makes meanwhile stay its own.  The
      device-wide synchronize and cache release that ``torch.cuda.graph``
      does first are skipped: they would stall the serving thread.

    The default stream then waits for the capture stream, so no replay
    reads a buffer before the warm-up and capture are done.  A call copies
    into the static buffers only the inputs that are not the tensor last
    copied at its current version (parameters stay put), replays the graph
    on the caller's current stream and returns copies of the outputs: the
    graph's own outputs are overwritten by the next replay, and a value
    returned by one call must not change after the next.  Each replay adds
    the launches its capture recorded to the kernels' counters.  A failed
    capture or replay raises; :meth:`release` frees the graph and its
    memory pool.  With donation (``kernel.aliases``) the capture is of the
    walk without it, and a call lands each aliased output in the caller's
    donated input after the replay and returns that input: the graph's
    addresses are fixed, the caller's state is written where it lies.
    """

    def __init__(self, kernel: SpecializedKernel, inputs: "tuple[torch.Tensor, ...]") -> None:
        from repro_torch.kernels.native import recording_launches

        if not inputs or any(x.device.type != "cuda" for x in inputs):
            raise ValueError(f"{kernel.name!r}: a CUDA graph needs every input on "
                             f"the card")
        self.name = kernel.name
        self.kernel = kernel          # the walk captured (what a store writes)
        device = inputs[0].device
        with torch.cuda.device(device), _capture_lock:
            self._seen = [(weakref.ref(x), x._version) for x in inputs]
            self._static_in = [_copy_pass(x) for x in inputs]
            default = torch.cuda.current_stream(device)
            stream = _capture_stream(device.index)
            stream.wait_stream(default)
            self._graph = torch.cuda.CUDAGraph()
            # the walk without donation: the graph keeps private outputs,
            # which a call lands in the caller's donated inputs after replay
            with torch.cuda.stream(stream):
                kernel._walk(kernel.hops, self._static_in, donate=False)
                with recording_launches() as record:
                    self._graph.capture_begin(capture_error_mode="thread_local")
                    try:
                        self._static_out = kernel._walk(kernel.hops, self._static_in,
                                                        donate=False)
                    finally:
                        self._graph.capture_end()
            default.wait_stream(stream)
        self._launches = [(c, v, n) for (c, v), n in record.items()]
        self.replays = 0

    def launches_per_replay(self) -> dict[str, int]:
        """Kernel launches one replay makes, by kernel name."""
        out: dict[str, int] = {}
        for c, _, n in self._launches:
            out[c.name] = out.get(c.name, 0) + n
        return out

    def __call__(self, routes: Any, *inputs):
        if self._graph is None:
            raise RuntimeError(f"{self.name!r}: specialized artifact was released")
        if len(inputs) != len(self._static_in):
            raise TypeError(f"{self.name!r} takes {len(self._static_in)} inputs, "
                            f"got {len(inputs)}")
        for i, x in enumerate(inputs):
            last, version = self._seen[i]
            if last() is not x or x._version != version:
                self._static_in[i].copy_(x)
                self._seen[i] = (weakref.ref(x), x._version)
        self._graph.replay()
        self.replays += 1
        for c, variant, n in self._launches:
            c.add(variant, n)
        if not self.kernel.aliases:
            return pytree.tree_map(_copy_pass, self._static_out)
        static = self._static_out if isinstance(self._static_out, tuple) \
            else (self._static_out,)
        outs = list(static)
        landed = set()
        for o, i in donation_targets(inputs, self.kernel.aliases):
            outs[o] = write_back(inputs[i], static[o])
            landed.add(o)
        outs = [y if o in landed else pytree.tree_map(_copy_pass, y)
                for o, y in enumerate(outs)]
        return outs[0] if len(outs) == 1 else tuple(outs)

    def release(self) -> None:
        """Drop the graph, its static buffers and its private memory pool."""
        if self._graph is not None:
            self._graph.reset()
        self._graph = self._static_in = self._static_out = None
        self._seen = []


def bind_routes(kernel: Callable[..., Any], routes: Any) -> Callable[..., Any]:
    """Close a placement-invariant kernel over one placement's routes."""
    return partial(kernel, routes)


@dataclasses.dataclass
class AssembledAccelerator:
    """The product of JIT assembly: a callable plus its provenance."""

    name: str
    fn: Callable[..., Any]          # kernel with this placement's routes bound
    program: Program
    placement: Placement
    total_hops: int
    instruction_mix: dict[str, int]
    # residency handle (set by Overlay.assemble): which Fabric resident this
    # accelerator belongs to, and at which admission generation.  A stale
    # generation means its PR regions were reclaimed — callers re-assemble.
    resident_id: str | None = None
    generation: int = -1
    kernel: Kernel | None = None
    routes: Any = None
    # artifact tier this accelerator dispatches to: "generic" (relocatable,
    # routes as a runtime argument) or "specialized" (route-constant)
    tier: str = "generic"

    def __call__(self, *args):
        return self.fn(*args)


def assemble(graph: Graph, placement: Placement, *,
             program: Program | None = None, routes: Any = None,
             kernel: Kernel | None = None,
             hop_fn: "Callable[[Any, int], Any]" = local_hop,
             donate_argnums: "tuple[int, ...]" = ()) -> AssembledAccelerator:
    """JIT-assemble the accelerator: single-device execution with the
    default ``hop_fn``, ring shifts with :func:`assemble_sharded`'s.

    The returned accelerator carries the placement-invariant ``kernel`` and
    this placement's ``routes`` separately; ``fn`` is the bound pair."""
    graph.validate()
    program = program or compile_graph(graph, placement)
    kernel = kernel or build_kernel(graph, donate_argnums, hop_fn)
    if routes is None:
        routes = route_vector(graph, placement)
    return AssembledAccelerator(
        name=graph.name, fn=bind_routes(kernel, routes), program=program,
        placement=placement, total_hops=placement.total_hops,
        instruction_mix=program.mix(), kernel=kernel, routes=routes)


def tile_group(mesh: Any, axis: str) -> Any:
    """The process group of the mesh axis whose ranks are the tiles."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"the mesh has no {axis!r} axis (its axes: {names})")
    return mesh.get_group(axis)


def assemble_sharded(graph: Graph, placement: Placement, mesh: Any,
                     axis: str = "tiles", **kwargs: Any) -> AssembledAccelerator:
    """JIT-assemble with *real* transfers between devices: each hop is one
    ring shift along the ranks of ``axis`` of the ``DeviceMesh`` ``mesh``
    (:func:`ring_hops`); ``kwargs`` as :func:`assemble`'s.

    Every rank runs the operators SPMD-style on replicated inputs, but every
    dataflow edge whose endpoints are k tiles apart moves its operand k
    nearest-neighbour steps: the cost structure of the paper's pass-through
    tiles.  Each rank of the mesh must call the returned accelerator, with
    the same inputs, as each takes part in every shift."""
    acc = assemble(graph, placement, hop_fn=ring_hops(tile_group(mesh, axis)), **kwargs)
    return dataclasses.replace(acc, name=f"{graph.name}@{axis}")


def wrap_sharded_kernel(acc: AssembledAccelerator, graph: Graph) -> Callable[..., Any]:
    """The *placement-invariant* sharded kernel of ``acc``: it takes
    ``(routes, *inputs)``, the relocatable artifact the overlay caches.
    In and out are replicated: the overlay streams whole vectors *through*
    tiles and does not shard the data (that belongs to the model layer).
    The reference wraps its kernel in ``shard_map`` and ``jax.jit`` over a
    mesh; the port's kernel already runs SPMD on every rank of its own."""
    if acc.kernel is None or acc.kernel.hop_fn is local_hop:
        raise ValueError(f"{acc.name!r} was not assembled for a mesh "
                         f"(use assemble_sharded)")
    if len(graph.input_ids) != len(acc.kernel.input_ids):
        raise ValueError(f"{acc.name!r} takes {len(acc.kernel.input_ids)} inputs; "
                         f"the graph has {len(graph.input_ids)}")
    return acc.kernel


def wrap_sharded(acc: AssembledAccelerator, graph: Graph) -> Callable[..., Any]:
    """Ready-to-call sharded accelerator for ``acc``'s own placement (the
    routes-bound convenience over :func:`wrap_sharded_kernel`)."""
    return bind_routes(wrap_sharded_kernel(acc, graph), acc.routes)


def wrap_sharded_specialized(graph: Graph, hops: "tuple[int, ...]", mesh: Any,
                             axis: str = "tiles",
                             donate_argnums: "tuple[int, ...]" = ()) -> SpecializedKernel:
    """The route-CONSTANT sharded kernel, the specialized tier on a mesh:
    takes ``(routes, *inputs)`` like the generic tier, with each static hop
    an unrolled run of ring shifts (no hop count read at run time)."""
    return specialize_kernel(graph, hops, donate_argnums,
                             ring_hops(tile_group(mesh, axis)))
