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
* ``Overlay.reconfigure()``   — flush the fabric: placements + bitstreams
  (``relocate=True`` moves residents instead — kernels survive),
* ``Overlay.evict(name)``     — free one accelerator's PR regions,
* ``Overlay.defragment()`` / ``Overlay.relocate(graph, placement)`` /
  ``Overlay.repack(rid, budget)`` — move residents between placements
  *without* re-downloading: kernels are placement-free, only the route
  program is re-emitted,
* tiered route specialization — ``jitted.specialize(*args)`` builds the
  route-constant tier for a resident (on the card: the walk captured once
  as a CUDA graph, replayed on every dispatch) and swaps the dispatch
  record onto it; any relocation instantly despecializes back to the
  generic kernel,
* ``Overlay(cost_model_placement=True)`` — candidate placements scored in
  seconds-equivalent cost instead of first-fit, and priced reclaims,
* ``Overlay.assemble(graph)`` — the low-level IR path (hand-built Graphs),
  idempotent and cached: re-assembling the same graph signature is a hit.

All accelerators of one overlay co-reside on one :class:`Fabric`; an
admission that does not fit reclaims least-recently-used residents.  A
resident hit dispatches through an immutable per-entry dispatch record that
one generation read validates.

Port of the synchronous subset of ``repro/core/overlay.py``.  The overlay is
synchronous: where the reference queues work on its scheduler (a
specialization on the low lane, a rebind after a relocation), the port does
it inline.  Asynchronous downloads and the scheduler, the failure model,
the persistent store, the fleet, donation and the sanitizer wait for later
slices: the port's :class:`Overlay` raises on the keyword arguments that ask
for them instead of ignoring them.
"""

from __future__ import annotations

import dataclasses
import logging
import time
import weakref
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import cache as cache_lib
from repro_torch.core import interpreter as interp
from repro_torch.core import trace as trace_lib
from repro_torch.core.cache import BitstreamCache
from repro_torch.core.fabric import Fabric, FabricError, ResidentAccelerator
from repro_torch.core.graph import Graph
from repro_torch.core.isa import Program, compile_graph
from repro_torch.core.placement import (Coord, Placement, PlacementError,
                                        PlacementPolicy, TileGrid,
                                        candidate_placements, check_assignment,
                                        place, score_placement)
from repro_torch.serving.metrics import Histogram

logger = logging.getLogger(__name__)

# a resident whose specialization keeps failing stops being retried at its
# routes after this many attempts (the cap resets on relocation)
_MAX_SPEC_FAILURES = 3

# Overlay keyword arguments of the reference that belong to later slices of
# the port, and the subsystem each asks for.
_DEFERRED = {
    "mesh": "sharded assembly across devices",
    "tile_axis": "sharded assembly across devices",
    "async_downloads": "the asynchronous download scheduler",
    "download_workers": "the asynchronous download scheduler",
    "sanitize": "the invariant sanitizer",
    "store": "the persistent bitstream store",
    "store_path": "the persistent bitstream store",
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
    reclaims: int = 0           # evictions forced by placement pressure
    defrags: int = 0            # defragmentation passes that moved residents
    relocations: int = 0        # residents moved WITHOUT re-downloading
    defrag_failures: int = 0    # defrag passes aborted by an unplaceable survivor
    prefetches: int = 0         # downloads begun on a hint, not a demand
    prefetch_hits: int = 0      # demand requests satisfied by a prior prefetch


@dataclasses.dataclass(frozen=True)
class _DispatchRecord:
    """Immutable snapshot the dispatch fast path runs on, validated per call
    by ONE liveness + generation read against its resident: any residency
    change (evict, reclaim, relocate, reconfigure) kills or bumps the
    generation, so a stale record fails closed into the slow path, which
    rebuilds it."""

    fn: Callable[..., Any]               # routes-bound artifact of `tier`
    res: ResidentAccelerator
    generation: int
    tier: str                            # "generic" | "specialized"


@dataclasses.dataclass
class _JitEntry:
    """One (signature, static-args) instantiation of a jitted function."""

    lowered: trace_lib.Lowered
    acc: interp.AssembledAccelerator | None   # None: traced but not assembled
    trace_seconds: float            # capture + aten->Graph lowering
    assemble_seconds: float = 0.0   # placement + ISA compile + kernel build
    record: _DispatchRecord | None = None


@dataclasses.dataclass(frozen=True)
class _PendingSpecialize:
    """What a specialization is built from: the baked hop constants
    describe one placement, the resident's current one."""

    rid: str
    key: str                           # generic kernel key being specialized
    spec_key: str                      # key + baked hop vector
    graph: Graph
    hops: tuple
    inputs: tuple                      # example leaves (tensor or None)


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
        overlay._wrappers.add(self)

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
        ov = self.overlay
        acc = entry.acc
        # first assembly for this signature, the accelerator was reclaimed /
        # flushed since (re-place and re-download), or the wrapper's budget
        # changed and the resident relocated (a cheap rebind)
        if acc is None or not ov.resident_current(acc) or \
                ov.repack(acc.resident_id, self.tile_budget):
            t0 = time.perf_counter()
            entry.acc = ov.assemble(entry.lowered.graph, fixed=self.fixed,
                                    tile_budget=self.tile_budget)
            entry.assemble_seconds = time.perf_counter() - t0
        ov._publish_record(entry)
        return entry

    # -- public surface -------------------------------------------------------
    def lower(self, *args) -> trace_lib.Lowered:
        """The lowered IR for this signature (traced at most once)."""
        dyn, closed, static_repr = self._split(args)
        return self._traced(self._sig_key(dyn, static_repr), closed, dyn).lowered

    def accelerator(self, *args) -> interp.AssembledAccelerator:
        """The assembled accelerator for this signature (traces if needed)."""
        return self._entry(args).acc

    def timings(self, *args) -> dict[str, float]:
        """Frontend vs backend split for this signature."""
        e = self._entry(args)
        return {"trace_seconds": e.trace_seconds,
                "assemble_seconds": e.assemble_seconds}

    def prefetch(self, *args) -> None:
        """Hint: download this signature's bitstream before traffic needs
        it.  ``args`` may be concrete tensors or :class:`TensorSpec`
        pytrees.  The overlay is synchronous, so the download is paid here
        (AOT population); an already-resident signature is a no-op."""
        presplit = self._split(args)
        dyn, closed, static_repr = presplit
        entry = self._traced(self._sig_key(dyn, static_repr), closed, dyn)
        acc = entry.acc
        if acc is not None and self.overlay.resident_current(acc):
            return
        self._entry(args, _presplit=presplit)
        self.overlay.stats.prefetches += 1
        self.overlay._prefetched.add(entry.acc.resident_id)

    def specialize(self, *args) -> None:
        """Build the route-constant *specialized* tier for this signature
        and swap the dispatch record onto it.  ``args`` may be concrete
        tensors (the warm-up and capture read them) or :class:`TensorSpec`
        pytrees (zeros of those shapes are used).  Admits/downloads the
        generic tier first if needed; a no-op when the resident is already
        specialized.  On the card the tier is the walk captured as a CUDA
        graph; a capture that fails raises.  A later relocation instantly
        despecializes back to the generic kernel."""
        ov = self.overlay
        presplit = self._split(args)
        dyn, closed, static_repr = presplit
        entry = self._traced(self._sig_key(dyn, static_repr), closed, dyn)
        acc = entry.acc
        if acc is None or not ov.resident_current(acc):
            self._entry(args, _presplit=presplit)
        res = ov.fabric.get(entry.acc.resident_id)
        if res is None or res.tier != "generic" or res.spec_pending:
            return
        leaves = tuple(x if isinstance(x, torch.Tensor) else None
                       for x in pytree.tree_leaves(dyn))
        ov._specialize_now(entry, res, leaves)

    def __call__(self, *args):
        presplit = self._split(args)
        entry = self._entries.get(self._sig_key(presplit[0], presplit[2]))
        rec = entry.record if entry is not None else None
        # the ENTIRE hot-path validation: liveness + one generation read
        # (+ the wrapper's budget, when capped)
        if rec is None or not rec.res.live or \
                rec.res.generation != rec.generation or \
                (self.tile_budget is not None
                 and rec.res.tile_budget != self.tile_budget):
            entry = self._entry(args, _presplit=presplit)
            rec = entry.record
        return self._dispatch(entry, rec, presplit[0])

    def _dispatch(self, entry: _JitEntry, rec: _DispatchRecord, dyn: tuple):
        ov = self.overlay
        res = rec.res
        ov.fabric.touch_resident(res)
        if ov._prefetched:
            ov._note_demand(res.rid)
        flat = pytree.tree_leaves(dyn)
        if rec.tier == "specialized":
            ov.cache.spec_stats.specialized_hits += 1
        elif ov._auto_specialize and res.tier == "generic" \
                and not res.spec_pending \
                and res.spec_failures < _MAX_SPEC_FAILURES:
            # the trigger: a contiguous (zero-hop) or dispatch-stable
            # resident builds its route-constant tier; this call is still
            # served by the generic one
            res.stable_dispatches += 1
            if res.zero_hop or res.stable_dispatches >= ov.specialize_after:
                ov._specialize_now(entry, res, tuple(flat))
        t0 = time.perf_counter()
        out = rec.fn(*flat)
        us = (time.perf_counter() - t0) * 1e6
        res.dispatch_hist.record(us)
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
      auto_defragment: re-place surviving residents contiguously after every
        pressure reclaim (moves are relocations: no re-download).
      cost_aware_reclaim: reclaim the resident with the best
        age/re-download-cost ratio instead of pure LRU.  Off by default,
        as on the reference's synchronous overlay.
      auto_specialize: build the route-constant tier for residents whose
        placement is contiguous (zero pass-through hops) or whose routes
        have been stable for ``specialize_after`` dispatches, inline on the
        dispatch that crosses the threshold and after a defragment.  Off by
        default, as on the reference's synchronous overlay;
        ``jitted.specialize(*args)`` works either way.
      specialize_after: dispatch-stability threshold for that trigger.
      cost_model_placement: replace first-fit packing with the cost-model
        planner — candidate placements at several footprint budgets scored
        in seconds-equivalent cost (measured per-hop dispatch latency,
        co-location crowding, tile scarcity), and pressure reclaims priced
        by modeled re-download cost.  Off by default.
      autotune_thresholds: re-derive ``specialize_after`` and the
        auto-defragment trigger from live measurements.  Off by default.
    """

    def __init__(self, rows: int = 3, cols: int = 3, *,
                 policy: PlacementPolicy = PlacementPolicy.DYNAMIC,
                 large_fraction: float = 0.25,
                 cache_capacity: int = 256,
                 auto_defragment: bool = False,
                 cost_aware_reclaim: bool | None = None,
                 auto_specialize: bool | None = None,
                 specialize_after: int = 32,
                 cost_model_placement: bool | None = None,
                 autotune_thresholds: bool | None = None,
                 **deferred: Any) -> None:
        unknown = sorted(set(deferred) - set(_DEFERRED))
        if unknown:
            raise TypeError(f"Overlay() got unexpected keyword arguments {unknown}")
        if deferred:
            k = sorted(deferred)[0]
            raise NotImplementedError(
                f"Overlay({k}=...) asks for {_DEFERRED[k]}, which a later "
                f"slice of the port brings; this overlay is synchronous")
        if specialize_after < 1:
            raise ValueError("specialize_after must be >= 1")
        self.grid = TileGrid(rows, cols, large_fraction)
        self.policy = policy
        self.cache = BitstreamCache(cache_capacity)
        self.fabric = Fabric(self.grid)
        self.stats = OverlayStats()
        # the reference's defaults for a synchronous overlay (None = follow
        # async_downloads / the store, both absent here)
        self.auto_defragment = auto_defragment
        self.cost_aware_reclaim = bool(cost_aware_reclaim)
        self._auto_specialize = bool(auto_specialize)
        self.specialize_after = int(specialize_after)
        self.cost_model_placement = bool(cost_model_placement)
        self.autotune_thresholds = bool(autotune_thresholds)
        # adaptive auto-defragment gate (only consulted when autotuning):
        # fragmentation below which a post-reclaim defrag is skipped
        self.defrag_threshold = 0.25
        # consecutive admissions that each paid >= 1 reclaim — the
        # planner's churn detector (flips victim selection to MRU)
        self._reclaim_streak = 0
        self._last_placement: Placement | None = None
        self._wrappers: "weakref.WeakSet[JitAssembled]" = weakref.WeakSet()
        self._prefetched: set[str] = set()   # rids downloaded ahead of demand
        # dispatch observability: end-to-end host dispatch latency (us) and
        # total route hops per admitted or relocated placement
        self.dispatch_hist = Histogram()
        self.route_cost_hist = Histogram()

    def _note_demand(self, rid: str) -> None:
        """First demand access of a prefetched resident = one prefetch hit."""
        if rid in self._prefetched:
            self._prefetched.discard(rid)
            self.stats.prefetch_hits += 1

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

    # -- placement ------------------------------------------------------------
    def plan(self, graph: Graph, fixed: dict[int, Coord] | None = None, *,
             occupied: "set[Coord] | None" = None,
             tile_budget: int | None = None) -> tuple[Placement, Program]:
        """Placement + ISA program, without building the kernel.  Packs
        around the fabric's current residents by default (pass
        ``occupied=set()`` to plan against an empty fabric).  Does NOT
        admit the placement — a plan holds no tiles."""
        occ = self.fabric.occupied() if occupied is None else occupied
        placement = place(graph, self.grid, self.policy, fixed,
                          occupied=occ, max_tiles=tile_budget)
        return placement, compile_graph(graph, placement)

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
        fabric is empty.  Victim order is LRU, or age-per-re-download-cost
        with ``cost_aware_reclaim``.  A graph that cannot fit even an
        *empty* fabric is structurally unplaceable: it re-raises before
        evicting anyone.  With ``cost_model_placement`` the planner
        replaces first-fit."""
        if self.cost_model_placement:
            return self._plan_with_cost_model(graph, fixed, tile_budget)
        probed = False
        while True:
            try:
                return place(graph, self.grid, self.policy, fixed,
                             occupied=self.fabric.occupied(),
                             max_tiles=tile_budget)
            except PlacementError:
                victim = self.fabric.reclaim_victim(
                    cost_aware=self.cost_aware_reclaim)
                if victim is None:
                    raise
                if not probed:
                    place(graph, self.grid, self.policy, fixed,
                          occupied=frozenset(), max_tiles=tile_budget)
                    probed = True
                self._evict_resident(victim.rid)
                self.stats.reclaims += 1
                self._maybe_defragment()

    # -- cost-model placement planner -----------------------------------------
    _RECLAIM_PRIOR_S = 0.05       # price of a re-download not yet measured

    def _reclaim_prior(self) -> float:
        """Neutral re-download price: the mean measured cost, else a prior."""
        mean = self.fabric.mean_download_cost()
        return mean if mean > 0.0 else self._RECLAIM_PRIOR_S

    def _planner_hop_cost(self) -> float:
        """Per-hop steady-state price: a slice of the measured p50 dispatch
        latency, clamped; a fixed default until enough dispatches have
        landed for the p50 to stop reflecting cold first calls."""
        if self.dispatch_hist.count >= 16:
            p50_s = self.dispatch_hist.percentile(0.5) * 1e-6
            return min(1e-3, max(1e-5, 0.05 * p50_s))
        return 1e-4

    def _victim_price(self, res: ResidentAccelerator) -> float:
        """Modeled cost of reclaiming ``res`` now: what the next admission
        would pay to bring its kernel back (its measured download cost,
        else the neutral prior)."""
        cost = self.fabric.download_cost(res.rid) or res.download_cost
        return cost if cost > 0.0 else self._reclaim_prior()

    def _plan_with_cost_model(self, graph: Graph,
                              fixed: dict[int, Coord] | None,
                              tile_budget: int | None) -> Placement:
        """Cost-model replacement for first-fit: feasible candidates at
        several footprint budgets, the cheapest adopted in
        seconds-equivalent cost (hops at the measured per-hop price,
        co-location crowding, tile scarcity).  The quadratic scarcity term
        makes footprint expensive as the fabric fills, so admissions
        compact into fewer tiles instead of reclaiming whenever crowding is
        cheaper than the modeled re-download.  When nothing fits, the
        planner's victim is reclaimed and planning retries."""
        probed = False
        evicted = False
        while True:
            occ = self.fabric.occupied()
            cands = candidate_placements(graph, self.grid, self.policy, fixed,
                                         occupied=occ, max_tiles=tile_budget)
            if cands:
                self._reclaim_streak = (self._reclaim_streak + 1) if evicted \
                    else 0
                hop_s = self._planner_hop_cost()
                return min(cands, key=lambda p: score_placement(
                    p, hop_cost_s=hop_s, crowd_cost_s=2.0 * hop_s,
                    occupied_tiles=len(occ), num_tiles=self.grid.num_tiles,
                    tile_pressure_s=self._reclaim_prior()))
            victim = self._select_victim()
            if victim is None:
                # empty fabric and still unplaceable: place() raises
                return place(graph, self.grid, self.policy, fixed,
                             occupied=occ, max_tiles=tile_budget)
            if not probed:
                place(graph, self.grid, self.policy, fixed,
                      occupied=frozenset(), max_tiles=tile_budget)
                probed = True
            self._evict_resident(victim.rid)
            evicted = True
            self.stats.reclaims += 1
            self._maybe_defragment()

    def _select_victim(self) -> "ResidentAccelerator | None":
        """The planner's reclaim victim: the fabric's cost-aware choice
        under :meth:`_victim_price`, BUT when each of the last
        ``len(pool)`` admissions paid a reclaim the working set has
        outgrown the fabric and age order is pathological (a cyclic
        rotation's LRU resident is the one needed next).  Then the most
        recently used resident within 2x of the cheapest modeled
        re-download goes (Belady's rule for a loop longer than the cache)."""
        pool = list(self.fabric.residents.values())
        if not pool:
            return None
        if self._reclaim_streak >= len(pool):
            prices = {r.rid: self._victim_price(r) for r in pool}
            cheapest = min(prices.values())
            mru_pool = [r for r in pool
                        if prices[r.rid] <= 2.0 * cheapest + 1e-9]
            return max(mru_pool, key=lambda r: r.last_used)
        return self.fabric.reclaim_victim(cost_aware=True,
                                          price=self._victim_price)

    def _maybe_defragment(self) -> None:
        """Post-reclaim defragment gate.  Plain ``auto_defragment`` runs a
        pass after every reclaim; with ``autotune_thresholds`` the pass runs
        only once fragmentation crosses an adaptive threshold, which a pass
        that moved nobody raises and a pass that compacted lowers."""
        if not self.auto_defragment:
            return
        if not self.autotune_thresholds:
            self.defragment()
            return
        if self.fabric.fragmentation() < self.defrag_threshold:
            return
        if self.defragment() == 0:
            self.defrag_threshold = min(0.9, self.defrag_threshold * 1.5 + 0.01)
        else:
            self.defrag_threshold = max(0.02, self.defrag_threshold * 0.75)

    def _autotune(self) -> None:
        """Re-derive ``specialize_after`` from measurements (no-op unless
        ``autotune_thresholds``): amortize the mean specialization cost
        over dispatches at the measured p50 latency, assuming a 25% saving
        a dispatch, clamped to [8, 512]."""
        if not self.autotune_thresholds:
            return
        ss = self.cache.spec_stats
        if not ss.specializations or not self.dispatch_hist.count:
            return
        spec_cost = ss.compile_seconds / ss.specializations
        p50_s = self.dispatch_hist.percentile(0.5) * 1e-6
        if p50_s <= 0.0 or spec_cost <= 0.0:
            return
        self.specialize_after = min(512, max(8, int(spec_cost / (0.25 * p50_s))))

    # -- admission and assembly -----------------------------------------------
    def _get_or_admit(self, graph: Graph, rid: str,
                      fixed: dict[int, Coord] | None,
                      tile_budget: int | None) -> ResidentAccelerator:
        """Resident lookup-or-admission (the PR download decision)."""
        resident = self.fabric.get(rid)
        if resident is not None:
            self.fabric.touch(rid)
            if tile_budget is not None and tile_budget != resident.tile_budget:
                # budget repack: re-place under the new footprint cap and
                # RELOCATE — the kernel is placement-free, so a resize
                # never pays a re-download
                self._repack_budget(resident, tile_budget)
            return resident
        placement = self._place_with_reclaim(graph, fixed, tile_budget)
        program = compile_graph(graph, placement)
        resident = self.fabric.admit(rid, graph.name, graph, placement,
                                     program, tile_budget=tile_budget,
                                     fixed=fixed)
        self._bind_routes_eager(resident)
        self.stats.downloads += 1
        # only a real re-place changes the fabric layout
        if self._last_placement is not None and \
                placement.assignment != self._last_placement.assignment:
            self.stats.reconfigurations += 1
        self._last_placement = placement
        return resident

    def _bind_routes_eager(self, resident: ResidentAccelerator) -> None:
        """Build the resident's routes vector ONCE, at admit/relocate time
        — dispatch only ever reads ``resident.routes``."""
        graph, placement = resident.graph, resident.placement
        resident.routes = self.cache.route_program(
            resident.rid, placement.descriptor(),
            lambda: interp.route_vector(graph, placement))
        hops = interp.route_hops(graph, placement)
        resident.zero_hop = interp.zero_hop(hops)
        resident.route_cost = int(sum(hops))
        self.route_cost_hist.record(resident.route_cost)

    @staticmethod
    def _bind_acc(resident: ResidentAccelerator,
                  kernel: interp.Kernel) -> interp.AssembledAccelerator:
        """The resident's accelerator: ``kernel`` bound to its current
        routes (rebuilt only after a move or a kernel change)."""
        if resident.acc is None or resident.acc.kernel is not kernel:
            acc = interp.assemble(resident.graph, resident.placement,
                                  program=resident.program,
                                  routes=resident.routes, kernel=kernel)
            resident.acc = dataclasses.replace(
                acc, resident_id=resident.rid, generation=resident.generation)
        return resident.acc

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
        hit = self.fabric.get(rid) is not None
        resident = self._get_or_admit(graph, rid, fixed, tile_budget)
        if hit:
            self._note_demand(rid)
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
        return self._bind_acc(resident, kernel)

    def _publish_record(self, entry: _JitEntry) -> None:
        """(Re)derive an entry's dispatch record from its accelerator,
        picking the best live tier: the resident's specialized artifact
        when it carries one, else the generic routes-bound kernel.  A
        non-current residency publishes None."""
        acc = entry.acc
        rec = None
        res = self.fabric.get(acc.resident_id) if acc is not None else None
        if res is not None and res.generation == acc.generation:
            fn, tier = acc.fn, "generic"
            if res.tier == "specialized" and res.spec_fn is not None:
                fn, tier = res.spec_fn, "specialized"
            rec = _DispatchRecord(fn=fn, res=res, generation=res.generation,
                                  tier=tier)
        entry.record = rec

    # -- relocation -----------------------------------------------------------
    def _repack_budget(self, resident: ResidentAccelerator,
                       tile_budget: int | None) -> None:
        """Re-place a resident under a changed footprint cap via relocation.
        Best-effort: under pressure the old placement stands and the new
        budget applies at the next re-place."""
        occ = self.fabric.occupied() - resident.tiles
        try:
            pl = place(resident.graph, self.grid, self.policy, resident.fixed,
                       occupied=occ, max_tiles=tile_budget)
        except PlacementError:
            resident.tile_budget = tile_budget
            return
        resident.tile_budget = tile_budget
        if pl.assignment != resident.placement.assignment:
            self._relocate_resident(resident.rid, pl)

    def _relocate_resident(self, rid: str, placement: Placement,
                           ignore: "tuple[str, ...]" = ()
                           ) -> ResidentAccelerator:
        """THE relocation path: re-emit the controller program and the
        routes for the new placement, rehome the tiles and rebind the live
        jit entries.  Kernel artifacts, the bitstream cache and the
        download ledger are untouched — the move costs route emission, not
        a PR download."""
        res = self.fabric.get(rid)
        program = compile_graph(res.graph, placement)
        # the routes are about to change: the route-constant tier is
        # unusable the moment they do — despecialize FIRST, then rehome
        self._despecialize(res)
        # old-placement route programs die with the move
        self.cache.evict_routes(rid)
        res = self.fabric.relocate(rid, placement, program, ignore=ignore)
        self._bind_routes_eager(res)
        self.stats.relocations += 1
        self._rebind_resident(rid)
        return res

    def _rebind_resident(self, rid: str) -> None:
        """Rebind every live jit entry of ``rid`` onto its cached kernel
        with the resident's current routes (cheap: no build), so the first
        call after a move already takes the fast path.  The reference runs
        this as a priority job after an asynchronous relocation; the
        synchronous port runs it inline."""
        res = self.fabric.get(rid)
        kernel = self.cache.peek(self._kernel_key(res.graph,
                                                  res.graph.input_avals()))
        if kernel is None:
            return                 # kernel gone: the demand path re-downloads
        acc = self._bind_acc(res, kernel)
        for wrapper in list(self._wrappers):
            for entry in wrapper._entries.values():
                if entry.acc is not None and entry.acc.resident_id == rid:
                    entry.acc = acc
                    self._publish_record(entry)

    def repack(self, rid: str, tile_budget: int | None) -> bool:
        """Re-place a resident under a changed footprint cap via relocation.
        No-op (False) when ``tile_budget`` is None, unchanged, or the rid is
        not resident; True when the resident actually moved."""
        if tile_budget is None:
            return False
        res = self.fabric.get(rid)
        if res is None or res.tile_budget == tile_budget:
            return False
        gen = res.generation
        self._repack_budget(res, tile_budget)
        return self.fabric.get(rid).generation != gen

    def relocate(self, target: "Graph | str",
                 placement: Placement) -> ResidentAccelerator:
        """Move a resident accelerator to ``placement`` without paying a
        re-download.  ``target`` is a graph, an accelerator name (as
        :meth:`evict` takes — must name exactly one resident), or a
        resident id.  The new tiles must be free of *other* residents, and
        the placement must pass :func:`check_assignment`.  Returns the
        relocated resident."""
        if isinstance(target, Graph):
            rid = self._resident_key(target, target.input_avals(), None)
        else:
            rid = str(target)
            if self.fabric.get(rid) is None:
                named = [r.rid for r in self.fabric.residents.values()
                         if r.name == rid]
                if len(named) > 1:
                    raise FabricError(
                        f"relocate: {rid!r} names {len(named)} residents "
                        f"— pass a specific resident id")
                if named:
                    rid = named[0]
        res = self.fabric.get(rid)
        if res is None:
            raise FabricError(f"relocate: no resident for {target!r}")
        # internal paths build placements via place(); a user-supplied one
        # must prove the same invariants before touching the fabric
        check_assignment(res.graph, self.grid, placement)
        return self._relocate_resident(rid, placement)

    def defragment(self) -> int:
        """Re-place surviving residents contiguously (most-recently-used
        first) to close occupancy holes left by evictions.

        Moves are **relocations**: a moved resident keeps its kernel and
        its download ledger; only the route program is re-emitted.
        All-or-nothing: if any survivor fails to re-place, nothing moves,
        ``stats.defrag_failures`` counts the aborted pass and a warning
        names the blocking resident.  Returns the number of residents
        moved."""
        def abort(res: ResidentAccelerator, exc: PlacementError) -> bool:
            self.stats.defrag_failures += 1
            logger.warning(
                "defragment aborted: resident %r (%s, %d tiles, "
                "tile_budget=%s) cannot be re-placed — %s",
                res.rid, res.name, len(res.tiles), res.tile_budget, exc)
            return False

        plan = self._plan_repack(abort)
        if plan is None:
            return 0
        moved = 0
        plan_rids = tuple(res.rid for res, _ in plan)
        for res, pl in plan:
            if pl.assignment == res.placement.assignment:
                continue
            self._relocate_resident(res.rid, pl, ignore=plan_rids)
            moved += 1
        if moved:
            self.stats.defrags += 1
            # compaction's point is the contiguous steady state: build the
            # zero-hop tier for residents that reached it
            self._enqueue_contiguous_specializations()
        return moved

    def _plan_repack(self, on_failure: "Callable[[ResidentAccelerator, PlacementError], bool]"
                     ) -> "list[tuple[ResidentAccelerator, Placement]] | None":
        """The shared re-place planner behind defragment() and
        reconfigure(relocate=True): MRU-first plan over movable residents,
        pinned residents anchoring the packing.  ``on_failure(res, exc)``
        decides what an unplaceable survivor means — True skips it and
        keeps planning, False aborts (None is returned)."""
        survivors = self.fabric.lru_order()[::-1]   # MRU packs first
        plan: list[tuple[ResidentAccelerator, Placement]] = []
        scratch: set[Coord] = set()
        for res in survivors:
            if res.fixed is not None:
                scratch |= res.tiles
        for res in survivors:
            if res.fixed is not None:
                continue
            try:
                pl = place(res.graph, self.grid, self.policy,
                           occupied=scratch, max_tiles=res.tile_budget)
            except PlacementError as exc:
                if on_failure(res, exc):
                    continue
                return None
            plan.append((res, pl))
            scratch |= set(pl.assignment.values())
        return plan

    # -- tiered route specialization ------------------------------------------
    def _spec_snapshot(self, entry: _JitEntry, res: ResidentAccelerator,
                       inputs: tuple | None) -> _PendingSpecialize | None:
        """What to specialize (entry, res) from, or None when it is
        impossible or pointless now: one variant per resident at a time,
        and a resident whose specialization keeps failing stops being
        retried at these routes."""
        if not res.live or res.tier != "generic" or res.spec_pending \
                or res.spec_failures >= _MAX_SPEC_FAILURES:
            return None
        graph = entry.lowered.graph
        key = self._kernel_key(graph, graph.input_avals())
        hops = interp.route_hops(graph, res.placement)
        return _PendingSpecialize(
            rid=res.rid, key=key,
            spec_key=cache_lib.spec_key(key, hops), graph=graph, hops=hops,
            inputs=inputs or (None,) * len(graph.input_ids))

    def _specialize_now(self, entry: _JitEntry, res: ResidentAccelerator,
                        inputs: tuple | None) -> Any:
        """Build the route-constant tier on the caller and commit it.  A
        failure is counted on the resident and re-raised: there is no
        quiet fallback to the generic tier."""
        pending = self._spec_snapshot(entry, res, inputs)
        if pending is None:
            return None
        res.spec_pending = True
        res.spec_job = f"specialize:{pending.spec_key}"
        t0 = time.perf_counter()
        try:
            exe = self._compile_specialized_tier(pending)
        except BaseException:
            res.spec_pending = False
            res.spec_job = None
            res.spec_failures += 1
            raise
        return self._commit_specialized(pending, exe, time.perf_counter() - t0)

    def _compile_specialized_tier(self, pending: _PendingSpecialize) -> Any:
        """The route-constant artifact: on the card the walk with its hops
        baked in, captured as a CUDA graph (an eager warm-up walk, then the
        capture, on the given inputs or zeros of the signature); on the CPU
        the walk itself."""
        kernel = interp.specialize_kernel(pending.graph, pending.hops)
        avals = pending.graph.input_avals()
        if not any(a.device is not None and torch.device(a.device).type == "cuda"
                   for a in avals):
            return kernel
        inputs = tuple(x if x is not None else
                       torch.zeros(a.shape, dtype=a.dtype, device=a.device)
                       for x, a in zip(pending.inputs, avals))
        return interp.GraphKernel(kernel, inputs)

    def _commit_specialized(self, pending: _PendingSpecialize, exe: Any,
                            seconds: float) -> Any:
        """Publish a finished route-constant build and swap every live entry
        of the resident onto it.  The build ran inline, so the resident is
        still at the generation it was built for (the reference also drops
        builds a relocation overtook: ``dropped_stale``, always 0 here)."""
        res = self.fabric.get(pending.rid)
        self.cache.insert_specialized(pending.spec_key, exe, seconds)
        self.fabric.add_cache_key(pending.rid, pending.key)
        res.tier = "specialized"
        res.spec_pending = False
        res.spec_job = None
        fn = interp.bind_routes(exe, res.routes)
        res.spec_fn = fn
        for wrapper in list(self._wrappers):
            for entry in wrapper._entries.values():
                acc = entry.acc
                if acc is None or acc.resident_id != pending.rid \
                        or acc.generation != res.generation:
                    continue
                entry.record = _DispatchRecord(
                    fn=fn, res=res, generation=res.generation,
                    tier="specialized")
        self._autotune()
        return exe

    def _despecialize(self, res: ResidentAccelerator) -> None:
        """Overlay-side half of despecialization (callers follow up with
        ``Fabric.relocate``, the one tier-reset point): drop the resident's
        route-constant artifact and book the despecialization."""
        self._drop_spec_artifacts(res)
        if res.tier == "specialized":
            self.cache.spec_stats.despecializations += 1

    def _drop_spec_artifacts(self, res: ResidentAccelerator) -> None:
        """Drop exactly THIS resident's route-constant artifacts.  Spec keys
        include the hop vector, so a sibling resident sharing the kernel
        key at other routes keeps its own."""
        hops = interp.route_hops(res.graph, res.placement)
        for k in res.cache_keys:
            self.cache.drop_specialized_exact(cache_lib.spec_key(k, hops))

    def _enqueue_contiguous_specializations(self) -> None:
        """Post-defragment hook: with ``auto_specialize``, residents whose
        placement became contiguous (pass-through-free) build their
        route-constant tier, on zeros of their signature."""
        if not self._auto_specialize:
            return
        for wrapper in list(self._wrappers):
            for entry in list(wrapper._entries.values()):
                acc = entry.acc
                res = self.fabric.get(acc.resident_id) if acc is not None else None
                if res is not None and res.zero_hop:
                    self._specialize_now(entry, res, None)

    # -- explicit PR-region management ----------------------------------------
    def _evict_resident(self, rid: str) -> int:
        """THE evict path: release a resident's tiles and drop its
        specialized artifacts, its route programs and the kernel artifacts
        no surviving resident shares.  Returns cache entries removed."""
        resident = self.fabric.release(rid)
        if resident is None:
            return 0
        # the route-constant tier dies with its resident even when the
        # generic kernel key survives via a sharing sibling
        self._drop_spec_artifacts(resident)
        if resident.tier == "specialized":
            self.cache.spec_stats.despecializations += 1
        self._prefetched.discard(rid)
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
        survive the flush.

        ``relocate=True`` instead re-places every movable resident under
        the new policy/grid via relocation — kernels, the cache and the
        download ledger survive.  Residents that no longer fit are evicted
        (the flush would have dropped them too); pinned residents keep
        their tiles."""
        if relocate:
            return self._reconfigure_relocating(policy, large_fraction)
        self._prefetched.clear()
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

    def _reconfigure_relocating(self, policy: PlacementPolicy | None,
                                large_fraction: float | None) -> dict[str, Any]:
        if policy is not None:
            self.policy = policy
        if large_fraction is not None:
            self.grid = TileGrid(self.grid.rows, self.grid.cols, large_fraction)
            self.fabric.grid = self.grid

        def evict_and_continue(res: ResidentAccelerator,
                               exc: PlacementError) -> bool:
            self._evict_resident(res.rid)
            return True

        plan = self._plan_repack(evict_and_continue)
        plan_rids = tuple(res.rid for res, _ in plan)
        for res, pl in plan:
            if pl.assignment != res.placement.assignment \
                    or pl.policy is not res.placement.policy:
                self._relocate_resident(res.rid, pl, ignore=plan_rids)
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
            "specialization": {
                **dataclasses.asdict(self.cache.spec_stats),
                "specialized_artifacts": self.cache.specialized_count(),
                "auto": self._auto_specialize,
                "specialize_after": self.specialize_after,
            },
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
            "defrags": self.stats.defrags,
            "relocations": self.stats.relocations,
            "defrag_failures": self.stats.defrag_failures,
            "cost_aware_reclaim": self.cost_aware_reclaim,
            "prefetches": self.stats.prefetches,
            "prefetch_hits": self.stats.prefetch_hits,
            "cost_model_placement": self.cost_model_placement,
            "autotune_thresholds": self.autotune_thresholds,
            "defrag_threshold": round(self.defrag_threshold, 4),
        }
