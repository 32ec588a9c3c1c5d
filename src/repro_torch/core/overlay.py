"""Overlay facade — the dynamic overlay the paper's runtime exposes.

The primary programming model is the *trace-based frontend* (the paper's
pitch: ordinary source code, no hardware programming model)::

    overlay = Overlay(rows=3, cols=3)              # build the fabric

    @overlay.jit                                   # or: acc = overlay.jit(fn)
    def dot(a, b):
        return torch.sum(a * b)

    y = dot(a, b)                                  # trace -> place -> assemble
                                                   # -> cached bitstream -> run

``overlay.jit`` captures the function at the aten level (``trace.py``),
lowers supported ops onto the operator library, builds a :class:`Graph` as
IR, and feeds it through placement / ISA / assembly.  Unmapped ops stay as
residue unless ``strict=True``.

Also provided, mirroring the paper's runtime controls:

* ``Overlay.aot(fn, *args)``  — ahead-of-time bitstream-cache population
  (pay the "PR download" before traffic arrives),
* ``Overlay.reconfigure()``   — flush the fabric: placements + bitstreams,
* ``Overlay.evict(name)``     — free one accelerator's PR regions,
* ``Overlay.assemble(graph)`` — the low-level IR path (hand-built Graphs),
  idempotent and cached: re-assembling the same graph signature is a hit.

All accelerators of one overlay co-reside on one :class:`Fabric`; an
admission that does not fit reclaims least-recently-used residents.  A
resident hit dispatches through an immutable per-entry dispatch record that
one generation read validates.

Port of the synchronous subset of ``repro/core/overlay.py``.  Asynchronous
downloads and the scheduler, the failure model, the persistent store, the
specialization tier, relocation (``relocate``/``defragment``/``repack``),
the cost-model planner, the fleet and the sanitizer wait for later slices:
the port's :class:`Overlay` raises on the keyword arguments that ask for
them instead of ignoring them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

from torch.utils import _pytree as pytree

from repro_torch.core import cache as cache_lib
from repro_torch.core import interpreter as interp
from repro_torch.core import trace as trace_lib
from repro_torch.core.cache import BitstreamCache
from repro_torch.core.fabric import Fabric, ResidentAccelerator
from repro_torch.core.graph import Graph
from repro_torch.core.isa import compile_graph
from repro_torch.core.placement import (Coord, Placement, PlacementError,
                                        PlacementPolicy, TileGrid, place)
from repro_torch.serving.metrics import Histogram

# Overlay keyword arguments of the reference that belong to later slices of
# the port, and the subsystem each asks for.
_DEFERRED = {
    "mesh": "sharded assembly across devices",
    "cost_aware_reclaim": "cost-aware reclaim, priced by the async pipeline",
    "tile_axis": "sharded assembly across devices",
    "auto_defragment": "relocation and defragmentation",
    "async_downloads": "the asynchronous download scheduler",
    "download_workers": "the asynchronous download scheduler",
    "auto_specialize": "the route-constant specialization tier",
    "specialize_after": "the route-constant specialization tier",
    "sanitize": "the invariant sanitizer",
    "store": "the persistent bitstream store",
    "store_path": "the persistent bitstream store",
    "cost_model_placement": "the cost-model placement planner",
    "autotune_thresholds": "the cost-model placement planner",
    "faults": "the failure model",
    "breaker_threshold": "the failure model",
    "retry_backoff": "the failure model",
    "breaker_probe_after": "the failure model",
    "download_deadline": "the failure model",
    "drain_timeout": "the asynchronous download scheduler",
}


@dataclasses.dataclass
class OverlayStats:
    assemblies: int = 0
    reconfigurations: int = 0   # placements changed between assemblies
    traces: int = 0             # frontend captures (jit/aot signatures)
    trace_seconds: float = 0.0  # total trace+lowering time (frontend cost)
    downloads: int = 0          # accelerators placed + admitted to the fabric
    evictions: int = 0          # residents released (explicit or reclaimed)
    reclaims: int = 0           # LRU evictions forced by placement pressure


@dataclasses.dataclass(frozen=True)
class _DispatchRecord:
    """Immutable snapshot the dispatch fast path runs on, validated per call
    by ONE liveness + generation read against its resident: any residency
    change (evict, reclaim, reconfigure) kills the generation, so a stale
    record fails closed into the slow path, which rebuilds it."""

    fn: Callable[..., Any]               # routes-bound kernel
    res: ResidentAccelerator
    generation: int


@dataclasses.dataclass
class _JitEntry:
    """One (signature, static-args) instantiation of a jitted function."""

    lowered: trace_lib.Lowered
    acc: interp.AssembledAccelerator | None   # None: traced but not assembled
    trace_seconds: float            # capture + aten->Graph lowering
    assemble_seconds: float = 0.0   # placement + ISA compile + kernel build
    record: _DispatchRecord | None = None


class JitAssembled:
    """Callable wrapper returned by :meth:`Overlay.jit`.

    Per input signature (flat shapes/dtypes/devices + static argument
    values) the wrapper traces once, assembles once, then dispatches
    straight to the cached accelerator.  Pytree arguments/results are
    supported; the graph sees one input per flat leaf.
    """

    def __init__(self, overlay: "Overlay", fn: Callable[..., Any], *,
                 strict: bool = False, name: str | None = None,
                 fixed: dict[int, Coord] | None = None,
                 static_argnums: tuple[int, ...] = (),
                 tile_budget: int | None = None) -> None:
        self.overlay = overlay
        self.fn = fn
        self.strict = strict
        self.name = name or getattr(fn, "__name__", None) or "jit"
        self.fixed = fixed
        self.static_argnums = tuple(static_argnums)
        self.tile_budget = tile_budget
        self._entries: dict[Any, _JitEntry] = {}
        self.__name__ = self.name
        self.__doc__ = getattr(fn, "__doc__", None)

    # -- signature handling ---------------------------------------------------
    @staticmethod
    def _sig_key(dyn: tuple, static_repr: str):
        """The entry-table key: flat abstract signature + pytree structure +
        static-argument values.  A hashable tuple: this runs per call."""
        leaves, treedef = pytree.tree_flatten(dyn)
        return (tuple(cache_lib.leaf_signature(a) for a in leaves),
                treedef, static_repr)

    def _split(self, args: tuple):
        """Split positional args into (dynamic args, closed fn, static repr)."""
        if not self.static_argnums:
            return args, self.fn, ""
        static = {i: args[i] for i in self.static_argnums if i < len(args)}
        dyn = tuple(a for i, a in enumerate(args) if i not in static)

        def closed(*dyn_args, _static=static, _n=len(args)):
            it = iter(dyn_args)
            full = [_static[i] if i in _static else next(it) for i in range(_n)]
            return self.fn(*full)

        closed.__name__ = self.name
        return dyn, closed, repr(sorted(static.items()))

    def _traced(self, key, closed: Callable[..., Any], dyn: tuple) -> _JitEntry:
        """The (possibly assembly-less) entry for a signature, tracing at
        most once: ``lower()`` and ``__call__`` share the memo."""
        entry = self._entries.get(key)
        if entry is None:
            t0 = time.perf_counter()
            lowered = trace_lib.trace_to_graph(closed, *dyn, name=self.name,
                                               strict=self.strict)
            dt = time.perf_counter() - t0
            self.overlay.stats.traces += 1
            self.overlay.stats.trace_seconds += dt
            entry = _JitEntry(lowered=lowered, acc=None, trace_seconds=dt)
            self._entries[key] = entry
        return entry

    def _entry(self, args: tuple, *, _presplit=None) -> _JitEntry:
        dyn, closed, static_repr = _presplit or self._split(args)
        entry = self._traced(self._sig_key(dyn, static_repr), closed, dyn)
        acc = entry.acc
        if acc is None or not self.overlay.resident_current(acc):
            # first assembly for this signature, or the accelerator was
            # reclaimed / flushed since: re-place and re-download
            t0 = time.perf_counter()
            entry.acc = self.overlay.assemble(entry.lowered.graph,
                                              fixed=self.fixed,
                                              tile_budget=self.tile_budget)
            entry.assemble_seconds = time.perf_counter() - t0
        self.overlay._publish_record(entry)
        return entry

    # -- public surface -------------------------------------------------------
    def lower(self, *args) -> trace_lib.Lowered:
        """The lowered IR for this signature (traced at most once)."""
        dyn, closed, static_repr = self._split(args)
        return self._traced(self._sig_key(dyn, static_repr), closed, dyn).lowered

    def accelerator(self, *args) -> interp.AssembledAccelerator:
        """The assembled accelerator for this signature (traces if needed)."""
        return self._entry(args).acc

    def __call__(self, *args):
        presplit = self._split(args)
        entry = self._entries.get(self._sig_key(presplit[0], presplit[2]))
        rec = entry.record if entry is not None else None
        # the ENTIRE hot-path validation: liveness + one generation read
        if rec is None or not rec.res.live or \
                rec.res.generation != rec.generation:
            entry = self._entry(args, _presplit=presplit)
            rec = entry.record
        return self._dispatch(entry, rec, presplit[0])

    def _dispatch(self, entry: _JitEntry, rec: _DispatchRecord, dyn: tuple):
        ov = self.overlay
        ov.fabric.touch_resident(rec.res)
        flat = pytree.tree_leaves(dyn)
        t0 = time.perf_counter()
        out = rec.fn(*flat)
        us = (time.perf_counter() - t0) * 1e6
        rec.res.dispatch_hist.record(us)
        ov.dispatch_hist.record(us)
        leaves = list(out) if len(entry.lowered.graph.output_ids) > 1 else [out]
        return pytree.tree_unflatten(leaves, entry.lowered.out_tree)


class Overlay:
    """A rows×cols dynamic overlay with a shared fabric and bitstream cache.

    Args:
      rows/cols: tile grid dimensions (paper evaluates 3×3).
      policy: DYNAMIC (paper's contribution) or STATIC (baseline).
      large_fraction: fraction of LARGE tiles (paper: 1/4).
      cache_capacity: bitstream cache slots.
    """

    def __init__(self, rows: int = 3, cols: int = 3, *,
                 policy: PlacementPolicy = PlacementPolicy.DYNAMIC,
                 large_fraction: float = 0.25,
                 cache_capacity: int = 256,
                 **deferred: Any) -> None:
        unknown = sorted(set(deferred) - set(_DEFERRED))
        if unknown:
            raise TypeError(f"Overlay() got unexpected keyword arguments {unknown}")
        if deferred:
            k = sorted(deferred)[0]
            raise NotImplementedError(
                f"Overlay({k}=...) asks for {_DEFERRED[k]}, which a later "
                f"slice of the port brings; this overlay is synchronous")
        self.grid = TileGrid(rows, cols, large_fraction)
        self.policy = policy
        self.cache = BitstreamCache(cache_capacity)
        self.fabric = Fabric(self.grid)
        self.stats = OverlayStats()
        self._last_placement: Placement | None = None
        # dispatch observability: end-to-end host dispatch latency (us) and
        # total route hops per admitted placement
        self.dispatch_hist = Histogram()
        self.route_cost_hist = Histogram()

    # -- trace-based frontend -------------------------------------------------
    def jit(self, fn: Callable[..., Any] | None = None, *,
            strict: bool = False, name: str | None = None,
            fixed: dict[int, Coord] | None = None,
            static_argnums: tuple[int, ...] = (),
            tile_budget: int | None = None) -> Callable[..., Any]:
        """Compile a plain PyTorch function into an overlay accelerator.

        Usable directly (``acc = overlay.jit(fn)``) or as a decorator.
        ``strict=True`` errors on aten ops without a library lowering.
        ``fixed`` pins graph nodes to tiles (static-placement experiments).
        ``tile_budget`` caps this accelerator's fabric footprint so it can
        co-reside with others.
        """
        def wrap(f: Callable[..., Any]) -> JitAssembled:
            return JitAssembled(self, f, strict=strict, name=name, fixed=fixed,
                                static_argnums=static_argnums,
                                tile_budget=tile_budget)
        return wrap if fn is None else wrap(fn)

    def aot(self, fn: Callable[..., Any], *abstract_args,
            strict: bool = False, name: str | None = None,
            fixed: dict[int, Coord] | None = None,
            tile_budget: int | None = None) -> JitAssembled:
        """Ahead-of-time assembly: pay the PR download for a signature
        before traffic arrives.  ``abstract_args`` are :class:`TensorSpec`
        pytrees (concrete tensors also work).  Calling the returned wrapper
        with matching inputs is a pure cache hit."""
        jitted = self.jit(fn, strict=strict, name=name, fixed=fixed,
                          tile_budget=tile_budget)
        jitted._entry(abstract_args)
        return jitted

    # -- assembly (low-level Graph IR path) -----------------------------------
    def _resident_key(self, graph: Graph, avals: tuple,
                      fixed: dict[int, Coord] | None) -> str:
        # `fixed` is part of the accelerator's identity: the same graph
        # pinned to different tiles is a different placement
        pins = repr(sorted(fixed.items())) if fixed else ""
        return cache_lib.cache_key(graph.name, cache_lib.signature_of(avals),
                                   placement_desc=pins,
                                   extra="resident:" + graph.fingerprint())

    def _kernel_key(self, graph: Graph, avals: tuple) -> str:
        """Placement-FREE identity of the kernel artifact: one kernel serves
        every placement of this graph (routes are a runtime argument)."""
        return cache_lib.kernel_key(graph.name, cache_lib.signature_of(avals),
                                    fingerprint=graph.fingerprint())

    def resident_current(self, acc: interp.AssembledAccelerator) -> bool:
        """Whether an assembled accelerator still holds its PR regions."""
        return self.fabric.is_current(acc.resident_id, acc.generation)

    def _place_with_reclaim(self, graph: Graph,
                            fixed: dict[int, Coord] | None,
                            tile_budget: int | None) -> Placement:
        """Place into free tiles; on pressure, reclaim residents (tiles +
        bitstreams via the one evict path) until the graph fits or the
        fabric is empty.  A graph that cannot fit even an *empty* fabric is
        structurally unplaceable: it re-raises before evicting anyone."""
        probed = False
        while True:
            try:
                return place(graph, self.grid, self.policy, fixed,
                             occupied=self.fabric.occupied(),
                             max_tiles=tile_budget)
            except PlacementError:
                victim = self.fabric.reclaim_victim()
                if victim is None:
                    raise
                if not probed:
                    place(graph, self.grid, self.policy, fixed,
                          occupied=frozenset(), max_tiles=tile_budget)
                    probed = True
                self._evict_resident(victim.rid)
                self.stats.reclaims += 1

    def _get_or_admit(self, graph: Graph, rid: str,
                      fixed: dict[int, Coord] | None,
                      tile_budget: int | None) -> ResidentAccelerator:
        """Resident lookup-or-admission (the PR download decision)."""
        resident = self.fabric.get(rid)
        if resident is not None:
            self.fabric.touch(rid)
            return resident
        placement = self._place_with_reclaim(graph, fixed, tile_budget)
        program = compile_graph(graph, placement)
        resident = self.fabric.admit(rid, graph.name, graph, placement,
                                     program, tile_budget=tile_budget,
                                     fixed=fixed)
        self._bind_routes_eager(graph, resident)
        self.stats.downloads += 1
        # only a real re-place changes the fabric layout
        if self._last_placement is not None and \
                placement.assignment != self._last_placement.assignment:
            self.stats.reconfigurations += 1
        self._last_placement = placement
        return resident

    def _bind_routes_eager(self, graph: Graph,
                           resident: ResidentAccelerator) -> None:
        """Build the resident's routes vector ONCE, at admission — dispatch
        only ever reads ``resident.routes``."""
        resident.routes = self.cache.route_program(
            resident.rid, resident.placement.descriptor(),
            lambda: interp.route_vector(graph, resident.placement))
        resident.route_cost = int(sum(interp.route_hops(graph, resident.placement)))
        self.route_cost_hist.record(resident.route_cost)

    def assemble(self, graph: Graph, *,
                 fixed: dict[int, Coord] | None = None,
                 tile_budget: int | None = None) -> interp.AssembledAccelerator:
        """JIT-assemble ``graph`` into a fabric-resident accelerator (cached).

        If the same graph+signature is already resident this is a pure hit:
        its placement (and tiles) are reused and its recency is bumped.
        Otherwise the graph is placed into the free tiles — reclaiming
        residents under pressure — admitted as a new resident, and its
        kernel is built (a download) unless the cache already holds it:
        the kernel is placement-free, so a re-admission at another
        placement reuses it."""
        graph.validate()
        avals = graph.input_avals()
        rid = self._resident_key(graph, avals, fixed)
        resident = self._get_or_admit(graph, rid, fixed, tile_budget)
        self.stats.assemblies += 1
        key = self._kernel_key(graph, avals)
        if key in resident.cache_keys and key not in self.cache:
            # the cache's own LRU dropped a resident's kernel: rebuilding it
            # is a real re-download — keep the ledger honest
            resident.cache_keys = tuple(k for k in resident.cache_keys
                                        if k in self.cache)
            self.stats.downloads += 1
        misses = self.cache.stats.misses
        t0 = time.perf_counter()
        kernel = self.cache.get_or_compile(key, lambda: interp.build_kernel(graph))
        if self.cache.stats.misses != misses:
            self.fabric.record_download_cost(rid, time.perf_counter() - t0)
        self.fabric.add_cache_key(rid, key)
        if resident.acc is None or resident.acc.kernel is not kernel:
            acc = interp.assemble(graph, resident.placement,
                                  program=resident.program,
                                  routes=resident.routes, kernel=kernel)
            resident.acc = dataclasses.replace(
                acc, resident_id=rid, generation=resident.generation)
        return resident.acc

    def _publish_record(self, entry: _JitEntry) -> None:
        """(Re)derive an entry's dispatch record from its accelerator; a
        non-current residency publishes None."""
        acc = entry.acc
        res = self.fabric.get(acc.resident_id) if acc is not None else None
        entry.record = (
            _DispatchRecord(fn=acc.fn, res=res, generation=res.generation)
            if res is not None and res.generation == acc.generation else None)

    # -- explicit PR-region management ----------------------------------------
    def _evict_resident(self, rid: str) -> int:
        """THE evict path: release a resident's tiles and drop its route
        programs and the kernel artifacts no surviving resident shares.
        Returns cache entries removed."""
        resident = self.fabric.release(rid)
        if resident is None:
            return 0
        self.stats.evictions += 1
        self.cache.evict_routes(rid)
        live_keys = {k for r in self.fabric.residents.values()
                     for k in r.cache_keys}
        return self.cache.evict_keys(
            [k for k in resident.cache_keys if k not in live_keys])

    def evict(self, target: "Graph | str") -> int:
        """Free one accelerator's PR regions AND its cached bitstreams (by
        graph or name — all resident signatures of that name).  Returns the
        number of cache entries removed."""
        name = target.name if isinstance(target, Graph) else str(target)
        removed = 0
        for rid in [r.rid for r in self.fabric.residents.values()
                    if r.name == name]:
            removed += self._evict_resident(rid)
        # sweep bitstreams with no residency record so evict-by-name stays
        # exhaustive
        return removed + self.cache.evict_prefix(f"{name}:")

    def reconfigure(self, *, policy: PlacementPolicy | None = None,
                    large_fraction: float | None = None,
                    relocate: bool = False) -> dict[str, Any]:
        """Full-fabric reconfiguration: flush every resident (tiles AND
        bitstreams; optionally switching placement policy / tile mix), so
        the next assembly re-places and re-downloads.  Cache statistics
        survive the flush.  ``relocate=True`` (move residents instead of
        flushing) belongs to the relocation slice and raises."""
        if relocate:
            raise NotImplementedError(
                "reconfigure(relocate=True) needs relocation, which a later "
                "slice of the port brings")
        if policy is not None:
            self.policy = policy
        if large_fraction is not None:
            self.grid = TileGrid(self.grid.rows, self.grid.cols, large_fraction)
        # reset() keeps the generation counter monotonic: handles assembled
        # before the flush never validate against post-flush re-admissions
        flushed = self.fabric.reset(self.grid)
        self.stats.evictions += len(flushed)
        self.cache.clear()
        self._last_placement = None
        self.stats.reconfigurations += 1
        return self.describe()

    # -- introspection ----------------------------------------------------------
    def describe(self) -> dict[str, Any]:
        return {
            "grid": (self.grid.rows, self.grid.cols),
            "large_tiles": len(self.grid.large_coords()),
            "policy": self.policy.value,
            "cache": dataclasses.asdict(self.cache.stats),
            "cached_bitstreams": len(self.cache),
            "route_programs": self.cache.route_programs(),
            "routes": dataclasses.asdict(self.cache.route_stats),
            "fabric": self.fabric.describe(),
            "dispatch_latency": self.dispatch_hist.summary(),
            "route_cost": self.route_cost_hist.summary(),
            "assemblies": self.stats.assemblies,
            "reconfigurations": self.stats.reconfigurations,
            "traces": self.stats.traces,
            "trace_seconds": self.stats.trace_seconds,
            "downloads": self.stats.downloads,
            "evictions": self.stats.evictions,
            "reclaims": self.stats.reclaims,
        }
