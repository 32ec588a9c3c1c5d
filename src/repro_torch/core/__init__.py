"""Core library: the paper's dynamic overlay + JIT assembly, in PyTorch.

Public API (frontend first — the paper's programming model):
  overlay.Overlay                          — trace-based frontend: plain
      PyTorch functions -> placed, ISA-compiled, cached accelerators
  trace.trace_to_graph / Lowered / TraceError — aten graph -> Graph lowering
  patterns.LIBRARY / Operator / TileClass  — operator ("bitstream") library
  patterns.register_op / register_call     — aten-op -> Operator registry
  graph.Graph / TensorSpec / vmul_reduce_graph — low-level symbolic DFG IR
  placement.TileGrid / PlacementPolicy     — static vs dynamic placement
  isa.compile_graph / Program / Opcode     — 42-instruction controller ISA
  interpreter.run_program / assemble       — eager ISA + JIT assembly
  cache.BitstreamCache                     — kernel-artifact (PR) cache
  fabric.Fabric / ResidentAccelerator      — shared-fabric tile residency
"""

from repro_torch.core.cache import BitstreamCache, kernel_key, signature_of
from repro_torch.core.fabric import Fabric, FabricError, ResidentAccelerator
from repro_torch.core.graph import (Graph, NodeRef, TensorSpec, branchy_graph,
                                    saxpy_graph, vmul_reduce_graph)
from repro_torch.core.interpreter import (AssembledAccelerator, Kernel,
                                          assemble, bind_routes, build_kernel,
                                          route_hops, route_vector, run_program)
from repro_torch.core.isa import (Opcode, Program, compile_compute,
                                  compile_graph, compile_routes)
from repro_torch.core.overlay import JitAssembled, Overlay, OverlayStats
from repro_torch.core.patterns import (LIBRARY, Operator, TileClass,
                                       make_filter, make_map, make_reduce,
                                       make_zip_with, register_call,
                                       register_op)
from repro_torch.core.placement import (Placement, PlacementError,
                                        PlacementPolicy, TileGrid,
                                        candidate_placements, place,
                                        place_dynamic, place_static)
from repro_torch.core.trace import Lowered, TraceError, trace_to_graph

__all__ = [
    "AssembledAccelerator", "BitstreamCache", "Fabric", "FabricError",
    "Graph", "JitAssembled", "Kernel", "LIBRARY", "Lowered", "NodeRef",
    "Opcode", "Operator", "Overlay", "OverlayStats", "Placement",
    "PlacementError", "PlacementPolicy", "Program", "ResidentAccelerator",
    "TensorSpec", "TileClass", "TileGrid", "TraceError", "assemble",
    "bind_routes", "branchy_graph", "build_kernel", "candidate_placements",
    "compile_compute", "compile_graph", "compile_routes", "kernel_key",
    "make_filter", "make_map", "make_reduce", "make_zip_with", "place",
    "place_dynamic", "place_static", "register_call", "register_op",
    "route_hops", "route_vector", "run_program", "saxpy_graph",
    "signature_of", "trace_to_graph", "vmul_reduce_graph",
]
