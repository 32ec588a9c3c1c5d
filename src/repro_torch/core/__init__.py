"""Core library: the paper's dynamic overlay + JIT assembly, in PyTorch.

Public API (frontend first — the paper's programming model):
  overlay.Overlay / jit / jit_assemble / default_overlay — trace-based
      frontend: plain PyTorch functions -> placed, ISA-compiled, cached
      accelerators (``jit(donate_argnums=)`` donates the state a step
      rewrites); the module-level forms use one process-wide 3x3 fabric
  fleet.FleetOverlay / FleetJitAssembled / FleetStats — many member
      fabrics behind the Overlay surface: placement, replication, routing,
      cross-fabric reclaim, member health
  trace.trace_to_graph / Lowered / TraceError — aten graph -> Graph lowering
  patterns.LIBRARY / Operator / TileClass  — operator ("bitstream") library
  patterns.register_op / register_call     — aten-op -> Operator registry
  graph.Graph / TensorSpec / vmul_reduce_graph — low-level symbolic DFG IR
  placement.TileGrid / PlacementPolicy     — static vs dynamic placement
  isa.compile_graph / Program / Opcode / Instruction — 42-instruction
      controller ISA
  interpreter.run_program / assemble       — eager ISA + JIT assembly
  interpreter.assemble_sharded / wrap_sharded* — the sharded mode: each
      hop a ring shift over a ``DeviceMesh`` axis (torch.distributed)
  interpreter.specialize_kernel / GraphKernel — the route-constant tier
      (on the card: a CUDA-graph replay of the walk)
  placement.score_placement / check_assignment — the cost-model planner's
      pure pieces and the relocation guard
  cache.BitstreamCache / cache_key / spec_key — kernel-artifact (PR) cache
      and its specialized tier
  fabric.Fabric / ResidentAccelerator      — shared-fabric tile residency,
      relocation
  scheduler.DownloadScheduler / DownloadHandle — the asynchronous
      PR-download pipeline (priority, FIFO and low lanes)
  faults.FaultPlan / FaultError            — seeded, replayable fault
      injection for the failure model
  store.BitstreamStore / StoreStats        — the persistent bitstream store
      (kernels in a serial form that names their operators; warm restarts)
"""

from repro_torch.core.cache import (BitstreamCache, SpecializationStats,
                                    cache_key, kernel_key, signature_of,
                                    spec_key)
from repro_torch.core.fabric import Fabric, FabricError, ResidentAccelerator
from repro_torch.core.faults import FaultError, FaultPlan
from repro_torch.core.fleet import FleetJitAssembled, FleetOverlay, FleetStats
from repro_torch.core.graph import (Graph, NodeRef, TensorSpec, branchy_graph,
                                    saxpy_graph, vmul_reduce_graph)
from repro_torch.core.interpreter import (AssembledAccelerator, GraphKernel,
                                          Kernel, SpecializedKernel, assemble,
                                          assemble_sharded, bind_routes,
                                          build_kernel, route_hops,
                                          route_vector, run_program,
                                          specialize_kernel, wrap_sharded,
                                          wrap_sharded_kernel,
                                          wrap_sharded_specialized, zero_hop)
from repro_torch.core.isa import (Instruction, Opcode, Program,
                                  compile_compute, compile_graph,
                                  compile_routes)
from repro_torch.core.overlay import (JitAssembled, Overlay, OverlayStats,
                                      default_overlay, jit, jit_assemble)
from repro_torch.core.patterns import (LIBRARY, Operator, TileClass,
                                       make_filter, make_map, make_reduce,
                                       make_zip_with, register_call,
                                       register_op)
from repro_torch.core.placement import (Placement, PlacementError,
                                        PlacementPolicy, TileGrid,
                                        candidate_placements, check_assignment,
                                        place, place_dynamic, place_static,
                                        placement_crowding,
                                        placement_footprint, score_placement)
from repro_torch.core.scheduler import DownloadHandle, DownloadScheduler
from repro_torch.core.store import BitstreamStore, StoreStats
from repro_torch.core.trace import Lowered, TraceError, trace_to_graph

__all__ = [
    "AssembledAccelerator", "BitstreamCache", "BitstreamStore", "DownloadHandle",
    "DownloadScheduler", "Fabric", "FabricError", "FaultError", "FaultPlan",
    "FleetJitAssembled", "FleetOverlay", "FleetStats",
    "Graph", "GraphKernel", "Instruction", "JitAssembled", "Kernel", "LIBRARY",
    "Lowered",
    "NodeRef", "Opcode", "Operator", "Overlay", "OverlayStats", "Placement",
    "PlacementError", "PlacementPolicy", "Program", "ResidentAccelerator",
    "SpecializationStats", "SpecializedKernel", "StoreStats", "TensorSpec",
    "TileClass",
    "TileGrid", "TraceError", "assemble", "assemble_sharded", "bind_routes",
    "branchy_graph",
    "build_kernel", "cache_key", "candidate_placements", "check_assignment",
    "compile_compute", "compile_graph", "compile_routes", "default_overlay",
    "jit", "jit_assemble", "kernel_key",
    "make_filter", "make_map", "make_reduce", "make_zip_with", "place",
    "place_dynamic", "place_static", "placement_crowding",
    "placement_footprint", "register_call", "register_op", "route_hops",
    "route_vector", "run_program", "saxpy_graph", "score_placement",
    "signature_of", "spec_key", "specialize_kernel", "trace_to_graph",
    "vmul_reduce_graph", "wrap_sharded", "wrap_sharded_kernel",
    "wrap_sharded_specialized", "zero_hop",
]
