"""Controller ISA — the 42-instruction set the runtime interpreter executes.

The paper's controller "currently interprets 42 different instructions
(interconnect: 22, branching: 6, vector operations: 2, Memory & Register
operations: 12)" (§II).  We reproduce the same four categories with the same
cardinalities.  A DFG + Placement compiles to a linear :class:`Program` of
these instructions; ``interpreter.py`` executes the program eagerly or
assembles the accelerator from the graph — ROUTE/BYPASS become copy passes
over the data, VEXEC invokes the placed operator bitstream, SELECT realizes
speculative branching.

Relocatable bitstreams: a program splits into a *placement-invariant compute
body* (:func:`compile_compute` — LD/VEXEC/SELECT/ST, tile bindings open) and
a cheap *route program* (:func:`compile_routes` — the ROUTE/BYPASS
interconnect a placement implies).  :func:`compile_graph` weaves the two into
the full controller program.

Port of ``repro/core/isa.py``, framework-free and verbatim apart from the
route-constant ``compile_specialized``, which waits for the slice that ports
the specialization tier.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any

from repro_torch.core.graph import Graph
from repro_torch.core.placement import Placement, route


class Opcode(enum.Enum):
    # ---- interconnect (22) — program the N-E-S-W mesh links ----
    ROUTE_N_IN = enum.auto();   ROUTE_E_IN = enum.auto()
    ROUTE_S_IN = enum.auto();   ROUTE_W_IN = enum.auto()
    ROUTE_N_OUT = enum.auto();  ROUTE_E_OUT = enum.auto()
    ROUTE_S_OUT = enum.auto();  ROUTE_W_OUT = enum.auto()
    BYPASS_NS = enum.auto();    BYPASS_SN = enum.auto()
    BYPASS_EW = enum.auto();    BYPASS_WE = enum.auto()
    BYPASS_NE = enum.auto();    BYPASS_NW = enum.auto()
    BYPASS_SE = enum.auto();    BYPASS_SW = enum.auto()
    CONSUME = enum.auto()       # tile consumes the incoming stream
    FORWARD = enum.auto()       # tile forwards its result downstream
    BROADCAST = enum.auto()     # one-to-many fanout
    GATHER = enum.auto()        # many-to-one fan-in
    SCATTER = enum.auto()       # partition a stream across tiles
    BARRIER = enum.auto()       # interconnect synchronization point

    # ---- branching (6) — speculative conditionals (C4) ----
    BR = enum.auto()            # unconditional branch (program order)
    BRZ = enum.auto()           # branch if zero
    BRNZ = enum.auto()          # branch if nonzero
    SPEC_BEGIN = enum.auto()    # open a speculative region (both arms run)
    SPEC_COMMIT = enum.auto()   # close the region
    SELECT = enum.auto()        # predicate picks the surviving arm

    # ---- vector operations (2) ----
    VEXEC = enum.auto()         # run the operator resident in a tile
    VEXEC_ACC = enum.auto()     # run with accumulation (reduce tiles)

    # ---- memory & register (12) ----
    LD_TILE = enum.auto()       # load tile-local BRAM (data in)
    ST_TILE = enum.auto()       # store tile-local BRAM (data out)
    LD_INSTR = enum.auto()      # load the instruction BRAM (new in this overlay)
    LD_CONST = enum.auto()      # load an immediate constant
    MOV = enum.auto()           # register-to-register move
    PUSH = enum.auto();         POP = enum.auto()
    SET_REG = enum.auto();      CLR_REG = enum.auto()
    LD_STREAM = enum.auto()     # stream external input into border BRAM
    ST_STREAM = enum.auto()     # stream result out
    FENCE = enum.auto()         # memory fence


INTERCONNECT_OPS = {
    Opcode.ROUTE_N_IN, Opcode.ROUTE_E_IN, Opcode.ROUTE_S_IN, Opcode.ROUTE_W_IN,
    Opcode.ROUTE_N_OUT, Opcode.ROUTE_E_OUT, Opcode.ROUTE_S_OUT, Opcode.ROUTE_W_OUT,
    Opcode.BYPASS_NS, Opcode.BYPASS_SN, Opcode.BYPASS_EW, Opcode.BYPASS_WE,
    Opcode.BYPASS_NE, Opcode.BYPASS_NW, Opcode.BYPASS_SE, Opcode.BYPASS_SW,
    Opcode.CONSUME, Opcode.FORWARD, Opcode.BROADCAST, Opcode.GATHER,
    Opcode.SCATTER, Opcode.BARRIER,
}
BRANCH_OPS = {Opcode.BR, Opcode.BRZ, Opcode.BRNZ,
              Opcode.SPEC_BEGIN, Opcode.SPEC_COMMIT, Opcode.SELECT}
VECTOR_OPS = {Opcode.VEXEC, Opcode.VEXEC_ACC}
MEMREG_OPS = {Opcode.LD_TILE, Opcode.ST_TILE, Opcode.LD_INSTR, Opcode.LD_CONST,
              Opcode.MOV, Opcode.PUSH, Opcode.POP, Opcode.SET_REG, Opcode.CLR_REG,
              Opcode.LD_STREAM, Opcode.ST_STREAM, Opcode.FENCE}

assert len(INTERCONNECT_OPS) == 22, len(INTERCONNECT_OPS)
assert len(BRANCH_OPS) == 6
assert len(VECTOR_OPS) == 2
assert len(MEMREG_OPS) == 12
assert len(Opcode) == 42


def category(op: Opcode) -> str:
    if op in INTERCONNECT_OPS:
        return "interconnect"
    if op in BRANCH_OPS:
        return "branching"
    if op in VECTOR_OPS:
        return "vector"
    return "memreg"


@dataclasses.dataclass(frozen=True)
class Instruction:
    opcode: Opcode
    # dst/src are node ids (dataflow registers); tile is the executing tile.
    dst: int | None = None
    srcs: tuple[int, ...] = ()
    tile: tuple[int, int] | None = None
    meta: Any = None

    def __repr__(self) -> str:  # compact listing for debug dumps
        t = f"@{self.tile}" if self.tile else ""
        s = ",".join(map(str, self.srcs))
        return f"{self.opcode.name}{t} d={self.dst} s=[{s}]"


@dataclasses.dataclass
class Program:
    name: str
    instructions: list[Instruction]

    def mix(self) -> dict[str, int]:
        """Instruction-category histogram (benchmarks/isa_mix.py)."""
        out = {"interconnect": 0, "branching": 0, "vector": 0, "memreg": 0}
        for ins in self.instructions:
            out[category(ins.opcode)] += 1
        return out

    def __len__(self) -> int:
        return len(self.instructions)


def _hop_opcode(frm: tuple[int, int], to: tuple[int, int]) -> Opcode:
    """Pick the directional route opcode for one nearest-neighbour hop."""
    dr, dc = to[0] - frm[0], to[1] - frm[1]
    if (dr, dc) == (0, 1):
        return Opcode.ROUTE_E_OUT
    if (dr, dc) == (0, -1):
        return Opcode.ROUTE_W_OUT
    if (dr, dc) == (1, 0):
        return Opcode.ROUTE_S_OUT
    if (dr, dc) == (-1, 0):
        return Opcode.ROUTE_N_OUT
    raise ValueError(f"non-adjacent hop {frm}->{to}")


def _emit_node_routes(node, assign: dict[int, "tuple[int, int]"], emit) -> None:
    """Interconnect instructions routing each producer edge to ``node``'s
    tile: ROUTE_*_OUT per hop plus BYPASS on the pass-through tiles.  This is
    the *placement-dependent* half of a program — it is all that changes
    when a resident accelerator relocates."""
    nid = node.node_id
    tile = assign[nid]
    for src in node.inputs:
        src_tile = assign.get(src)
        if src_tile is None or src_tile == tile:
            continue  # border input or co-located — no interconnect hops
        path = [src_tile] + route(src_tile, tile) + [tile]
        for a, b in zip(path[:-1], path[1:]):
            emit(Instruction(_hop_opcode(a, b), dst=nid, srcs=(src,), tile=a))
        # tiles strictly between src and dst only bypass (Fig. 2 pass-through)
        for pt in route(src_tile, tile):
            emit(Instruction(Opcode.BYPASS_EW, srcs=(src,), tile=pt))


def _emit_node_compute(node, emit, tile: "tuple[int, int] | None" = None) -> None:
    """Compute/memory instructions for one node — the *placement-invariant*
    half (``tile=None`` leaves the tile binding open; weaving a full program
    binds the placement's coordinate)."""
    nid = node.node_id
    if node.kind == "input":
        emit(Instruction(Opcode.LD_STREAM, dst=nid, meta=node.name))
        return
    if node.kind == "const":
        emit(Instruction(Opcode.LD_CONST, dst=nid, meta=node.name))
        return
    if node.kind == "select":
        pred, t, e = node.inputs
        emit(Instruction(Opcode.SPEC_BEGIN, tile=tile, srcs=(t, e)))
        emit(Instruction(Opcode.SELECT, dst=nid, srcs=(pred, t, e), tile=tile))
        emit(Instruction(Opcode.SPEC_COMMIT, tile=tile))
        return
    # kind == "op"
    emit(Instruction(Opcode.LD_TILE, dst=nid, srcs=node.inputs, tile=tile))
    is_reduce = node.op is not None and node.op.name.startswith(("reduce", "scan"))
    emit(Instruction(Opcode.VEXEC_ACC if is_reduce else Opcode.VEXEC,
                     dst=nid, srcs=node.inputs, tile=tile, meta=node.op))
    emit(Instruction(Opcode.SET_REG, dst=nid, tile=tile))


def compile_compute(graph: Graph) -> Program:
    """The placement-invariant compute body of a graph's controller program.

    Contains every LD/VEXEC/SELECT/ST instruction with the tile bindings
    left open — no ROUTE/BYPASS, because interconnect programming is a
    property of a *placement*, not of the graph.  One compute body serves
    every placement of the graph (relocatable-bitstream identity).
    """
    graph.validate()
    ins: list[Instruction] = []
    for node in graph.toposorted():
        _emit_node_compute(node, ins.append)
    for out in graph.output_ids:
        ins.append(Instruction(Opcode.ST_STREAM, srcs=(out,), meta="out"))
    ins.append(Instruction(Opcode.BARRIER))
    return Program(graph.name, ins)


def compile_routes(graph: Graph, placement: Placement) -> Program:
    """The placement-dependent route program: only the interconnect
    instructions (ROUTE hops + pass-through BYPASSes) a placement implies.
    Cheap to re-emit — this is all a relocation recompiles.
    """
    graph.validate()
    ins: list[Instruction] = []
    assign = placement.assignment
    for node in graph.toposorted():
        if node.kind == "op":
            _emit_node_routes(node, assign, ins.append)
    return Program(f"{graph.name}@routes", ins)


def compile_graph(graph: Graph, placement: Placement) -> Program:
    """Lower a placed DFG to the controller ISA (full woven program).

    Emission per node, in topological order:
      input   -> LD_STREAM (border BRAM in)
      const   -> LD_CONST
      op      -> routing (ROUTE_*_OUT per hop + BYPASS on pass-through tiles)
                 for every producer edge, then LD_TILE + VEXEC[_ACC] + SET_REG
      select  -> SPEC_BEGIN ... SELECT ... SPEC_COMMIT
      output  -> ST_STREAM (border BRAM out)

    Equivalent to weaving :func:`compile_compute` (placement-invariant) with
    :func:`compile_routes` (placement-dependent) and binding tiles.
    """
    graph.validate()
    ins: list[Instruction] = []
    emit = ins.append
    assign = placement.assignment

    for node in graph.toposorted():
        if node.kind == "op":
            _emit_node_routes(node, assign, emit)
            _emit_node_compute(node, emit, tile=assign[node.node_id])
        elif node.kind == "select":
            _emit_node_compute(node, emit, tile=assign.get(node.node_id))
        else:
            _emit_node_compute(node, emit)

    for out in graph.output_ids:
        emit(Instruction(Opcode.ST_STREAM, srcs=(out,), meta="out"))
    emit(Instruction(Opcode.BARRIER))
    return Program(graph.name, ins)
