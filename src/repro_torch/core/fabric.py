"""Fabric residency — per-tile occupancy across *all* assembled accelerators.

The paper's runtime downloads multiple pre-synthesized operator bitstreams
into the PR regions of ONE fabric: accelerators co-reside, and when a new
accelerator cannot find free regions the runtime evicts an old one and
reuses its tiles (§II–III).  :class:`Fabric` is that bookkeeping layer — the
single source of truth for which tile belongs to which resident:

* :meth:`admit` claims a placement's tiles for a resident (overlap = bug,
  raised as :class:`FabricError`; the placer must have packed into free
  tiles via ``placement.place(..., occupied=fabric.occupied())``),
* :meth:`relocate` rehomes a resident onto new tiles *without* forfeiting
  its kernel artifacts or download ledger (relocatable bitstreams: the
  kernel is placement-free; only the route program is re-emitted),
* :meth:`release` frees a resident's tiles (PR-region release),
* :meth:`touch` / :meth:`reclaim_victim` implement the recency (or
  age-per-re-download-cost) order the overlay reclaims in,
* :meth:`fragmentation` lifts the paper's internal-fragmentation metric
  (§II: LARGE regions squatted by SMALL operators) to the whole fabric.

``Fabric`` holds *no executables* — bitstreams live in the
:class:`~repro_torch.core.cache.BitstreamCache`; a resident records which
cache keys it owns so tile release and bitstream eviction travel through
one path (``Overlay.evict``).

The measurement ledger — download-cost EWMA, download counts and per-rid
dispatch-latency histograms — outlives residencies (a release stashes the
histogram, a re-admission re-seeds it) and the process:
:meth:`Fabric.export_ledger` is what the bitstream store persists and
:meth:`Fabric.seed_ledger` what a warm boot reads back.

Port of ``repro/core/fabric.py``: framework-free and nearly verbatim.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable

from repro_torch.core.graph import Graph
from repro_torch.core.isa import Program
from repro_torch.core.patterns import TileClass
from repro_torch.core.placement import Coord, Placement, TileGrid
from repro_torch.serving.metrics import Histogram


class FabricError(RuntimeError):
    """Residency invariant violation (e.g. admitting onto occupied tiles)."""


@dataclasses.dataclass
class ResidentAccelerator:
    """One accelerator currently downloaded into the fabric's PR regions."""

    rid: str                       # unique residency key (name + fingerprint + sig)
    name: str                      # graph name (evict-by-name groups on this)
    graph: Graph
    placement: Placement
    program: Program               # controller program
    tiles: frozenset[Coord]        # PR regions held
    occupants: dict[Coord, tuple[TileClass, ...]]  # per-tile operator classes
    generation: int                # bumped on every (re-)admission AND relocation
    last_used: int                 # fabric tick of last assembly/dispatch
    tile_budget: int | None = None # footprint cap this resident was placed under
    fixed: "dict[int, Coord] | None" = None  # pinned tiles
    cache_keys: tuple[str, ...] = ()   # kernel-artifact cache entries owned
    downloads: int = 1             # times this accelerator was placed+downloaded
    download_cost: float = 0.0     # measured download (kernel build) seconds
    acc: Any = None                # built AssembledAccelerator (hit fast path)
    # relocatable bitstreams: the generation at (re-)admission opens this
    # residency epoch; relocations bump `generation` but not this.
    # `relocations` counts moves since admission.
    admit_generation: int = -1
    relocations: int = 0
    # tiered route specialization: which artifact tier this resident's
    # dispatch records point at.  `routes` is the host-side hop vector
    # (built ONCE at admit/relocate, never on the dispatch path);
    # `zero_hop` caches whether the placement is pass-through-free;
    # `stable_dispatches` counts hits since the routes last changed (the
    # stability trigger); `spec_pending`/`spec_job` mark a specialization
    # in progress.  `live` flips False on release so dispatch records
    # invalidate with ONE read.
    tier: str = "generic"
    routes: Any = None
    zero_hop: bool = False
    stable_dispatches: int = 0
    spec_pending: bool = False
    spec_job: str | None = None
    spec_fn: Any = None            # bound specialized artifact (dispatch)
    spec_jit_kwargs: Any = None    # the jit kwargs (donation) spec_fn honors
    spec_failures: int = 0         # failed specializations at these routes
    live: bool = True
    # dispatch observability: per-resident end-to-end call latency (us) and
    # the total hop count of the route program
    dispatch_hist: Any = None
    route_cost: int = 0
    dispatch_failures: int = 0     # dispatches that raised (failure ledger)


def _occupants_of(graph: Graph, placement: Placement) -> dict[Coord, tuple[TileClass, ...]]:
    nodes = {n.node_id: n for n in graph.toposorted()}
    out: dict[Coord, list[TileClass]] = {}
    for nid, coord in placement.assignment.items():
        node = nodes[nid]
        cls = node.op.tile_class if node.op is not None else TileClass.SMALL
        out.setdefault(coord, []).append(cls)
    return {c: tuple(v) for c, v in out.items()}


class Fabric:
    """Occupancy ledger for one tile grid shared by many accelerators."""

    def __init__(self, grid: TileGrid) -> None:
        self.grid = grid
        self._residents: dict[str, ResidentAccelerator] = {}
        self._tick = 0
        self._generation = 0
        self._download_counts: dict[str, int] = {}   # per-rid, survives evict
        self._download_costs: dict[str, float] = {}  # rid -> measured build s
        # per-rid dispatch-latency history, stashed at release and re-seeded
        # at admit: like the cost EWMA, latency measurements price the
        # accelerator, not one residency, so eviction must not erase them
        self._dispatch_states: dict[str, dict] = {}

    def reset(self, grid: TileGrid | None = None) -> list[ResidentAccelerator]:
        """Flush every resident (optionally swapping the grid) while keeping
        the tick/generation counters monotonic — a stale pre-flush
        ``(rid, generation)`` handle must never validate against a
        post-flush re-admission.  Returns the flushed residents."""
        flushed = self.release_all()
        if grid is not None:
            self.grid = grid
        return flushed

    # -- queries --------------------------------------------------------------
    @property
    def residents(self) -> dict[str, ResidentAccelerator]:
        return dict(self._residents)

    def __len__(self) -> int:
        return len(self._residents)

    def get(self, rid: str) -> ResidentAccelerator | None:
        return self._residents.get(rid)

    def is_current(self, rid: str | None, generation: int) -> bool:
        """Whether (rid, generation) still names a live residency."""
        if rid is None:
            return False
        res = self._residents.get(rid)
        return res is not None and res.generation == generation

    def same_residency(self, rid: str | None, generation: int) -> bool:
        """Whether ``generation`` belongs to ``rid``'s *current residency
        epoch* — true for the live generation AND for pre-relocation
        generations of the same admission (a kernel built before a move is
        placement-free and still valid; one from before an evict is not)."""
        if rid is None:
            return False
        res = self._residents.get(rid)
        return (res is not None
                and res.admit_generation <= generation <= res.generation)

    def occupied(self) -> set[Coord]:
        out: set[Coord] = set()
        for res in self._residents.values():
            out |= res.tiles
        return out

    def free(self) -> list[Coord]:
        occ = self.occupied()
        return [c for c in self.grid.coords() if c not in occ]

    @property
    def utilization(self) -> float:
        return len(self.occupied()) / self.grid.num_tiles

    def lru(self) -> ResidentAccelerator | None:
        """The least-recently-used resident, or None."""
        if not self._residents:
            return None
        return min(self._residents.values(), key=lambda r: r.last_used)

    def mean_download_cost(self) -> float:
        """Mean of the measured per-rid re-download costs (0.0 when nothing
        has been measured) — the planner's neutral price for unknowns."""
        known = [c for c in self._download_costs.values() if c > 0.0]
        return sum(known) / len(known) if known else 0.0

    def reclaim_victim(self, *, cost_aware: bool = False,
                       prefer: "Callable[[ResidentAccelerator], bool] | None"
                       = None,
                       price: "Callable[[ResidentAccelerator], float] | None"
                       = None) -> ResidentAccelerator | None:
        """The resident to reclaim under placement pressure.

        Pure-LRU by default.  ``cost_aware=True`` scores each resident by
        staleness *per second of re-download cost* — ``age / download_cost``
        — and evicts the maximum: between two equally-cold residents the
        cheap-to-redownload one goes first.  A resident with no measurement
        yet is priced at the mean of the measured costs; with no
        measurements anywhere the choice is exactly LRU.  ``price``
        overrides a resident's re-download price (seconds) — the cost-model
        planner passes its own pricer here.

        ``prefer`` narrows the pool BEFORE the LRU or cost scoring: when any
        resident satisfies it, only those are candidates (a fleet member
        sacrifices copies that also live on another member before any sole
        copy); when none does, the whole pool is scored."""
        if not self._residents:
            return None
        pool = list(self._residents.values())
        if prefer is not None:
            preferred = [r for r in pool if prefer(r)]
            if preferred:
                pool = preferred
        if not cost_aware:
            return min(pool, key=lambda r: r.last_used)
        now = self._tick + 1
        known = [c for c in self._download_costs.values() if c > 0.0]
        prior = sum(known) / len(known) if known else 1.0

        def score(r: ResidentAccelerator) -> float:
            age = now - r.last_used
            if price is not None:
                cost = price(r)
            else:
                cost = (self._download_costs.get(r.rid) or r.download_cost
                        or prior)
            return age / (cost + 1e-3)

        return max(pool, key=score)

    def lru_order(self) -> list[ResidentAccelerator]:
        """Residents least-recently-used first."""
        return sorted(self._residents.values(), key=lambda r: r.last_used)

    # -- mutation -------------------------------------------------------------
    def touch(self, rid: str) -> None:
        res = self._residents.get(rid)
        if res is not None:
            self.touch_resident(res)

    def touch_resident(self, res: ResidentAccelerator) -> None:
        """Recency bump without the rid lookup (dispatch fast path)."""
        self._tick += 1
        res.last_used = self._tick

    def admit(self, rid: str, name: str, graph: Graph, placement: Placement,
              program: Program, *, tile_budget: int | None = None,
              fixed: "dict[int, Coord] | None" = None) -> ResidentAccelerator:
        """Claim ``placement``'s tiles for a new resident accelerator."""
        if rid in self._residents:
            raise FabricError(f"resident {rid!r} already admitted")
        tiles = frozenset(placement.assignment.values())
        clash = tiles & self.occupied()
        if clash:
            holders = {c: r.name for r in self._residents.values()
                       for c in r.tiles if c in clash}
            raise FabricError(
                f"placement for {name!r} overlaps occupied tiles {holders} — "
                f"place() must be given fabric.occupied()")
        self._tick += 1
        self._generation += 1
        self._download_counts[rid] = self._download_counts.get(rid, 0) + 1
        res = ResidentAccelerator(
            rid=rid, name=name, graph=graph, placement=placement,
            program=program, tiles=tiles,
            occupants=_occupants_of(graph, placement),
            generation=self._generation, last_used=self._tick,
            tile_budget=tile_budget, fixed=fixed,
            downloads=self._download_counts[rid],
            download_cost=self._download_costs.get(rid, 0.0),
            admit_generation=self._generation,
            dispatch_hist=Histogram())
        state = self._dispatch_states.get(rid)
        if state is not None:
            res.dispatch_hist = Histogram.from_state(state)
        self._residents[rid] = res
        return res

    def record_download_cost(self, rid: str, seconds: float) -> None:
        """Feed one measured download time into the per-rid cost model (EWMA,
        kept across evictions) — what a future reclaim would pay again."""
        prev = self._download_costs.get(rid)
        cost = seconds if prev is None else 0.5 * prev + 0.5 * seconds
        self._download_costs[rid] = cost
        res = self._residents.get(rid)
        if res is not None:
            res.download_cost = cost

    def download_cost(self, rid: str) -> float:
        """Modeled re-download cost in seconds (0.0 when never measured)."""
        return self._download_costs.get(rid, 0.0)

    def release(self, rid: str) -> ResidentAccelerator | None:
        """Free one resident's PR regions; returns it (for bitstream cleanup)."""
        res = self._residents.pop(rid, None)
        if res is not None:
            res.live = False          # dispatch records invalidate instantly
            self._stash_dispatch(res)
        return res

    def release_all(self) -> list[ResidentAccelerator]:
        out = list(self._residents.values())
        for res in out:
            res.live = False
            self._stash_dispatch(res)
        self._residents.clear()
        return out

    def _stash_dispatch(self, res: ResidentAccelerator) -> None:
        if res.dispatch_hist is not None and res.dispatch_hist.count:
            self._dispatch_states[res.rid] = res.dispatch_hist.state()

    # -- measurement ledger ---------------------------------------------------
    def export_ledger(self) -> dict[str, Any]:
        """Snapshot every cross-residency measurement — the download-cost
        EWMA, download counts and per-rid dispatch-latency histogram states
        (live residents included) — in the JSON shape the bitstream store
        persists (``BitstreamStore.save_ledger``)."""
        dispatch = dict(self._dispatch_states)
        for res in self._residents.values():
            if res.dispatch_hist is not None and res.dispatch_hist.count:
                dispatch[res.rid] = res.dispatch_hist.state()
        return {
            "download_costs": dict(self._download_costs),
            "download_counts": dict(self._download_counts),
            "dispatch": dispatch,
        }

    def seed_ledger(self, ledger: dict[str, Any]) -> int:
        """Re-seed measurements from a persisted ledger (warm boot).

        In-process measurements win: a rid that already has a live EWMA or
        histogram keeps it.  Malformed rows are skipped — ledger data comes
        off disk and must never break a boot.  Returns rows applied."""
        applied = 0
        costs = ledger.get("download_costs")
        if isinstance(costs, dict):
            for rid, cost in costs.items():
                try:
                    cost = float(cost)
                except (TypeError, ValueError):
                    continue
                if cost >= 0.0 and rid not in self._download_costs:
                    self._download_costs[rid] = cost
                    res = self._residents.get(rid)
                    if res is not None and res.download_cost == 0.0:
                        res.download_cost = cost
                    applied += 1
        counts = ledger.get("download_counts")
        if isinstance(counts, dict):
            for rid, n in counts.items():
                try:
                    n = int(n)
                except (TypeError, ValueError):
                    continue
                if n > self._download_counts.get(rid, 0):
                    self._download_counts[rid] = n
        dispatch = ledger.get("dispatch")
        if isinstance(dispatch, dict):
            for rid, state in dispatch.items():
                if rid in self._dispatch_states or not isinstance(state, dict):
                    continue
                hist = Histogram.from_state(state)
                if hist.count:
                    self._dispatch_states[rid] = state
                    res = self._residents.get(rid)
                    if res is not None and res.dispatch_hist is not None \
                            and not res.dispatch_hist.count:
                        res.dispatch_hist = hist
                    applied += 1
        return applied

    def add_cache_key(self, rid: str, key: str) -> None:
        res = self._residents.get(rid)
        if res is not None and key not in res.cache_keys:
            res.cache_keys = res.cache_keys + (key,)

    def relocate(self, rid: str, placement: Placement, program: Program, *,
                 ignore: "Iterable[str]" = ()) -> ResidentAccelerator:
        """Move a resident to a new placement — the relocatable-bitstream
        path (defragmentation, budget repacks, policy moves).

        The new tiles must be free (overlap with *other* residents raises
        :class:`FabricError`; overlap with the resident's own old tiles is
        fine) and ``program`` must be the controller program recompiled for
        the new placement.  Unlike an evict + re-admit, the resident KEEPS
        its kernel-artifact ``cache_keys`` and its download ledger; only
        the route program changes.  The generation bumps (stale dispatch
        records fail closed) while ``admit_generation`` stays.

        ``ignore`` names residents whose *old* tiles don't count as clashes
        — a multi-resident repack moves several residents onto a mutually
        disjoint plan, so tiles about to be vacated by a later move of the
        same plan are fair game."""
        res = self._residents.get(rid)
        if res is None:
            raise FabricError(f"relocate: no resident {rid!r}")
        skip = set(ignore) | {rid}
        occupied_others: set[Coord] = set()
        for other in self._residents.values():
            if other.rid not in skip:
                occupied_others |= other.tiles
        tiles = frozenset(placement.assignment.values())
        clash = tiles & occupied_others
        if clash:
            holders = {c: r.name for r in self._residents.values()
                       if r.rid not in skip for c in r.tiles if c in clash}
            raise FabricError(
                f"relocation of {res.name!r} overlaps occupied tiles "
                f"{holders}")
        res.placement = placement
        res.program = program
        res.tiles = tiles
        res.occupants = _occupants_of(res.graph, placement)
        self._generation += 1
        res.generation = self._generation
        res.relocations += 1
        res.acc = None                # routes changed — rebind (cheap)
        # the move invalidates the route-constant tier INSTANTLY: the routes
        # it was specialized for no longer describe the resident's tiles.
        # This is THE tier-reset point; Overlay._despecialize (called just
        # before relocating) drops the artifact and books the change.
        res.tier = "generic"
        res.routes = None
        res.zero_hop = False
        res.stable_dispatches = 0
        res.spec_pending = False
        res.spec_job = None
        res.spec_fn = None
        res.spec_failures = 0         # new routes: specialization may retry
        return res

    # -- metrics --------------------------------------------------------------
    def fragmentation(self) -> float:
        """Fraction of occupied LARGE tiles holding only SMALL operators,
        across every co-resident accelerator (paper §II, fabric-wide)."""
        large = set(self.grid.large_coords())
        if not large:
            return 0.0
        occupied_large = [classes for res in self._residents.values()
                          for coord, classes in res.occupants.items()
                          if coord in large]
        if not occupied_large:
            return 0.0
        wasted = sum(1 for classes in occupied_large
                     if all(c is TileClass.SMALL for c in classes))
        return wasted / len(occupied_large)

    def describe(self) -> dict[str, Any]:
        occ = self.occupied()
        return {
            "tiles": self.grid.num_tiles,
            "tiles_used": len(occ),
            "tiles_free": self.grid.num_tiles - len(occ),
            "utilization": round(self.utilization, 4),
            "fragmentation": round(self.fragmentation(), 4),
            "residents": {
                res.rid: {"name": res.name,
                          "tiles": sorted(res.tiles),
                          "downloads": res.downloads,
                          "download_cost": round(res.download_cost, 6),
                          "relocations": res.relocations,
                          "tier": res.tier,
                          "zero_hop": res.zero_hop,
                          "specializing": res.spec_pending,
                          "last_used": res.last_used,
                          "route_cost": res.route_cost,
                          "dispatch_failures": res.dispatch_failures,
                          "dispatch_latency": res.dispatch_hist.summary()}
                for res in self.lru_order()
            },
        }
