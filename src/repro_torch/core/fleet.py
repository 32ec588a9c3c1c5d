"""Fleet overlay — many fabrics behind the one-overlay API surface.

One :class:`~repro_torch.core.overlay.Overlay` is the paper's story on a
single shared PR fabric.  A :class:`FleetOverlay` owns N member overlays and
presents the same frontend (``jit`` / ``aot`` / ``assemble`` / ``evict`` /
``reconfigure`` / ``defragment`` / ``describe``), adding the policies a
multi-fabric deployment needs:

* **Placement** — a new signature is homed on the member with the best
  *placement score* (:meth:`FleetOverlay._member_score`): free-tile
  headroom, minus the member's share of the dispatches routed in the current
  window, minus the price of displacing its residents, minus its measured
  dispatch latency relative to the slowest member's, minus its health.
* **Replication** — a signature routed at least ``replicate_after`` times
  inside one window gets a *replica* on another member, downloaded on that
  member scheduler's LOW lane (it never delays a demand download); when
  traffic subsides below ``drain_below`` an extra copy is torn down.
* **Routing** — each dispatch goes to the least-loaded live copy (healthy
  members first, then fewest in-flight calls, then fewest lifetime
  dispatches), through a per-signature :class:`_FleetRecord` whose replica
  tuple rebalances swap whole; the dispatch path takes no fleet lock.
* **Cross-fabric reclaim** — every member's pressure reclaim prefers a
  resident that has a live copy on another member
  (``Overlay.reclaim_prefer`` -> ``Fabric.reclaim_victim(prefer=)``): the
  fleet sheds redundancy first and never loses the last copy of a signature
  to make room.
* **Health** — a member whose failures in one window reach
  ``quarantine_errors`` is quarantined (placement and routing avoid it),
  readmitted after clean windows; :meth:`FleetOverlay.kill_member` (or the
  fault plan's ``member_deaths``) flushes a member and evacuates its sole
  copies.

The members stay whole single overlays: each has its own scheduler workers,
relocation, specialization and cost-aware reclaim.  On the card the members
share one device; the weights are call arguments, so no member holds a copy
of them, and CUDA-graph captures serialize on ``interpreter._capture_lock``.

Donation (``jit(..., donate_argnums=)``) reaches every member wrapper.  A
failed dispatch is answered by the failed member's fallback WITHOUT landing
in the donated inputs, so the retry on another copy reads the caller's state
as it was; when no other copy can serve, the fleet lands the fallback's
answer itself.

Port of ``repro/core/fleet.py``.  Deviation: the retry decision reads the
member call's own failure flag (``JitAssembled._invoke``) instead of the
member's failure counter, so a concurrent failure of another signature on
the same member cannot trigger a retry, which after a donated dispatch
would read the new state.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import weakref
from typing import Any, Callable, Sequence

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.fabric import ResidentAccelerator
from repro_torch.core.faults import FaultPlan
from repro_torch.core.graph import Graph, TensorSpec
from repro_torch.core.overlay import JitAssembled, Overlay
from repro_torch.core.placement import PlacementError
from repro_torch.core.store import BitstreamStore

__all__ = ["FleetOverlay", "FleetJitAssembled", "FleetStats"]


@dataclasses.dataclass
class FleetStats:
    placements: int = 0          # signatures homed on a member
    replications: int = 0        # replicas downloaded onto extra members
    replica_teardowns: int = 0   # replicas torn down (traffic subsided)
    replicas_lost: int = 0       # copies pruned after member-side reclaim/evict
    failovers: int = 0           # dispatches served off-primary (primary dead)
    rebalances: int = 0          # watermark evaluation passes
    routed: int = 0              # total dispatches routed fleet-wide
    quarantines: int = 0         # members pulled from placement (error burst)
    readmissions: int = 0        # quarantined members returned to service
    evacuations: int = 0         # sole copies re-homed off a dead member
    member_deaths: int = 0       # members declared dead (admin or fault plan)
    dispatch_retries: int = 0    # failed dispatches re-served by another copy


@dataclasses.dataclass
class _MemberHealth:
    """Per-member health ledger driving quarantine and routing bias.

    ``healthy -> quarantined`` when a rebalance window observes at least
    ``quarantine_errors`` new member-side failures; ``quarantined ->
    probation`` after ``quarantine_windows`` consecutive clean windows;
    ``probation -> healthy`` after one more clean window (a readmission) or
    back to ``quarantined`` on any error.  ``dead`` is terminal and entered
    only through :meth:`FleetOverlay.kill_member`."""

    state: str = "healthy"       # healthy | probation | quarantined | dead
    last_seen: int = 0           # member error total at the last window edge
    window_errors: int = 0       # errors observed in the last window
    clean_windows: int = 0       # consecutive clean windows while quarantined


@dataclasses.dataclass
class _Replica:
    """One copy of a signature on one member.  ``inflight``/``routed`` are
    the least-loaded routing signals, bumped without a lock on the dispatch
    path (estimates, not ledgers)."""

    member_index: int
    wrapper: JitAssembled
    routed: int = 0              # dispatches routed here (lifetime)
    inflight: int = 0            # calls currently executing


@dataclasses.dataclass
class _FleetRecord:
    """Routing record for one (fleet wrapper, signature).

    ``replicas`` is replaced whole (a tuple swap) by placement, replication,
    teardown and pruning under the fleet lock; the dispatch path reads one
    snapshot of it and checks each copy with the member's liveness read."""

    label: str                   # JSON-friendly identity ("name#n")
    sig_key: Any                 # JitAssembled entry-table key (hashable)
    args_spec: tuple             # TensorSpec-ified args (for replication)
    replicas: tuple[_Replica, ...]
    hits: int = 0                # lifetime dispatches
    window_hits: int = 0         # dispatches since the last rebalance


class FleetJitAssembled:
    """Callable returned by :meth:`FleetOverlay.jit` — the fleet's
    :class:`~repro_torch.core.overlay.JitAssembled`.

    Per signature the wrapper homes the accelerator on one member (the
    placement score decides which), keeps a routing record over its live
    copies and dispatches each call to the least-loaded one.  Member-level
    wrappers are made lazily, one per member that ever hosts a copy; each
    traces on its own (trace cost is per member, paid once)."""

    def __init__(self, fleet: "FleetOverlay", fn: Callable[..., Any], *,
                 strict: bool = False, name: str | None = None,
                 static_argnums: tuple[int, ...] = (),
                 donate_argnums: tuple[int, ...] = (),
                 tile_budget: int | None = None) -> None:
        self.fleet = fleet
        self.fn = fn
        self.strict = strict
        self.name = name or getattr(fn, "__name__", None) or "jit"
        self.static_argnums = tuple(static_argnums)
        self.donate_argnums = tuple(donate_argnums)
        self._tile_budget = tile_budget
        self._records: dict[Any, _FleetRecord] = {}
        self._member_wrappers: dict[int, JitAssembled] = {}
        self.__name__ = self.name
        self.__doc__ = getattr(fn, "__doc__", None)
        fleet._register(self)

    # ``ServeEngine.resize`` sets ``tile_budget``: every member wrapper gets
    # the new cap, and its next dispatch repacks the resident by relocation
    @property
    def tile_budget(self) -> int | None:
        return self._tile_budget

    @tile_budget.setter
    def tile_budget(self, value: int | None) -> None:
        self._tile_budget = value
        for w in self._member_wrappers.values():
            w.tile_budget = value

    # -- signature handling (agrees with JitAssembled._sig_key) ---------------
    def _split(self, args: tuple):
        if not self.static_argnums:
            return args, ""
        static = {i: args[i] for i in self.static_argnums if i < len(args)}
        dyn = tuple(a for i, a in enumerate(args) if i not in static)
        return dyn, repr(sorted(static.items()))

    def _key(self, args: tuple):
        dyn, static_repr = self._split(args)
        return JitAssembled._sig_key(dyn, static_repr)

    def _member_wrapper(self, idx: int) -> JitAssembled:
        w = self._member_wrappers.get(idx)
        if w is None:
            w = self.fleet.members[idx].jit(
                self.fn, strict=self.strict, name=self.name,
                static_argnums=self.static_argnums,
                donate_argnums=self.donate_argnums,
                tile_budget=self._tile_budget)
            self._member_wrappers[idx] = w
        return w

    def _args_spec(self, args: tuple) -> tuple:
        """The args as :class:`TensorSpec` pytrees, for replication to ask
        for this signature later on another member without keeping the
        caller's tensors alive (``prefetch`` takes them).  The entry key
        reads (shape, dtype, device), so the specs reproduce it exactly."""
        def leaf(a):
            if isinstance(a, torch.Tensor):
                return TensorSpec(tuple(a.shape), a.dtype, a.device)
            return a                        # non-tensor leaf: kept verbatim

        return tuple(a if i in self.static_argnums else pytree.tree_map(leaf, a)
                     for i, a in enumerate(args))

    def _record(self, args: tuple) -> _FleetRecord:
        key = self._key(args)
        rec = self._records.get(key)
        if rec is not None:
            return rec
        fleet = self.fleet
        with fleet._lock:
            rec = self._records.get(key)     # re-check under the lock
            if rec is not None:
                return rec
            idx = fleet._best_member()
            rec = _FleetRecord(
                label=f"{self.name}#{len(self._records)}",
                sig_key=key, args_spec=self._args_spec(args),
                replicas=(_Replica(idx, self._member_wrapper(idx)),))
            self._records[key] = rec
            fleet.stats.placements += 1
            return rec

    # -- public surface -------------------------------------------------------
    def __call__(self, *args):
        return self.fleet._dispatch(self._record(args), args)

    def prefetch(self, *args):
        """Home this signature (placement score) and start its download on
        the chosen member ahead of demand.  ``args`` may be tensors or
        :class:`TensorSpec` pytrees."""
        return self._record(args).replicas[0].wrapper.prefetch(*args)

    def specialize(self, *args):
        """Request the route-constant tier for the signature's primary copy;
        replicas specialize on their own members through the usual
        triggers."""
        return self._record(args).replicas[0].wrapper.specialize(*args)


class FleetOverlay:
    """N member :class:`~repro_torch.core.overlay.Overlay` fabrics behind
    the single-overlay API surface.

    Args:
      members: the fleet size (members are built as
        ``Overlay(rows, cols, **overlay_kwargs)``), or a sequence of
        already-built overlays (a heterogeneous fleet).
      rows/cols: member fabric dimensions (fleet-built members only).
      window: dispatches between watermark evaluations — the replication
        controller's sampling period.
      replicate_after: a signature routed at least this many times inside
        one window gains a replica on the best member not hosting it.
      drain_below: a replicated signature routed at most this many times
        inside one window loses one replica (default ``replicate_after //
        4``: hysteresis, so a hovering rate does not flap).
      max_replicas: cap on live copies a signature (default: fleet size).
      quarantine_errors / quarantine_windows: the health machine's
        thresholds (see :class:`_MemberHealth`).
      faults: a :class:`~repro_torch.core.faults.FaultPlan` shared by the
        fleet-built members; its ``member_deaths`` kill members by fleet
        dispatch count.
      store / store_path: one :class:`~repro_torch.core.store.BitstreamStore`
        for the whole fleet — members persist into and warm-boot from one
        directory, and one in-process store object gives them one store
        lock.
      **overlay_kwargs: passed to every fleet-built member
        (``async_downloads=True`` gives the fleet background replication).
    """

    def __init__(self, members: "int | Sequence[Overlay]" = 4, *,
                 rows: int = 3, cols: int = 3,
                 window: int = 128,
                 replicate_after: int = 32,
                 drain_below: int | None = None,
                 max_replicas: int | None = None,
                 quarantine_errors: int = 3,
                 quarantine_windows: int = 2,
                 faults: "FaultPlan | None" = None,
                 store: "BitstreamStore | None" = None,
                 store_path: "str | None" = None,
                 **overlay_kwargs: Any) -> None:
        if store is not None and store_path is not None:
            raise ValueError("pass store= or store_path=, not both")
        if store is None and store_path is not None:
            store = BitstreamStore(store_path, faults=faults)
        self.store = store
        self.faults = faults
        if isinstance(members, int):
            if members < 1:
                raise ValueError("a fleet needs at least one member")
            if store is not None:
                overlay_kwargs = dict(overlay_kwargs, store=store)
            if faults is not None:
                overlay_kwargs = dict(overlay_kwargs, faults=faults)
            members = [Overlay(rows, cols, **overlay_kwargs)
                       for _ in range(members)]
        else:
            if overlay_kwargs:
                raise ValueError(
                    "overlay kwargs only apply to fleet-built members; "
                    "configure explicit member overlays directly")
            if store is not None:
                raise ValueError(
                    "a fleet store only applies to fleet-built members; "
                    "pass store= to the explicit member overlays")
            members = list(members)
            if not members:
                raise ValueError("a fleet needs at least one member")
            stores = {id(m.store) for m in members if m.store is not None}
            if len(stores) == 1:
                self.store = next(m.store for m in members if m.store is not None)
            if faults is None:
                plans = {id(m.faults) for m in members if m.faults is not None}
                if len(plans) == 1:
                    self.faults = next(m.faults for m in members
                                       if m.faults is not None)
        self.members: list[Overlay] = members
        if window < 1:
            raise ValueError("window must be >= 1")
        if replicate_after < 1:
            raise ValueError("replicate_after must be >= 1")
        self.window = int(window)
        self.replicate_after = int(replicate_after)
        self.drain_below = (max(1, self.replicate_after // 4)
                            if drain_below is None else int(drain_below))
        if self.drain_below >= self.replicate_after:
            raise ValueError("drain_below must be < replicate_after (hysteresis)")
        self.max_replicas = (len(members) if max_replicas is None
                             else max(1, min(int(max_replicas), len(members))))
        if quarantine_errors < 1 or quarantine_windows < 1:
            raise ValueError("quarantine_errors and quarantine_windows must be >= 1")
        self.quarantine_errors = int(quarantine_errors)
        self.quarantine_windows = int(quarantine_windows)
        self._health = [_MemberHealth() for _ in members]
        # a sanitizing member (sanitize= or REPRO_SANITIZE) turns on the
        # fleet-level record checks after each rebalance
        self.sanitize = any(m.sanitize for m in members)
        self.stats = FleetStats()
        self._lock = threading.RLock()
        self._wrappers: "weakref.WeakSet[FleetJitAssembled]" = weakref.WeakSet()
        self._dispatches = 0
        self._window_routed = [0] * len(members)     # load score input
        self._routed_total = [0] * len(members)      # describe() ledger
        self._graph_homes: dict[str, int] = {}       # low-level assemble path
        for idx, member in enumerate(self.members):
            member.reclaim_prefer = self._replica_preference(idx)

    # -- member compatibility surface (ServeEngine and friends) ---------------
    @property
    def grid(self):
        """The member fabric geometry (a per-accelerator tile budget is per
        member fabric)."""
        return self.members[0].grid

    @property
    def async_downloads(self) -> bool:
        return any(m.async_downloads for m in self.members)

    def _register(self, wrapper: FleetJitAssembled) -> None:
        self._wrappers.add(wrapper)

    # -- placement score ------------------------------------------------------
    def _member_score(self, idx: int) -> float:
        """The placement score, from signals the members already keep:

        ``free``    — free-tile fraction (capacity headroom);
        ``load``    — the member's share of the dispatches routed fleet-wide
                      in the current window;
        ``price``   — the mean download-cost EWMA of its residents, squashed
                      to [0, 1) and scaled by occupancy (what landing under
                      pressure there would pay to re-download);
        ``latency`` — its p50 dispatch latency over the slowest member's,
                      from the overlay histograms; 0 until a dispatch is
                      recorded, so a cold fleet places as before;
        ``health``  — a dead member scores ``-inf``, a quarantined one takes
                      -1, a probationary one -0.25, and recent window errors
                      a graded penalty.
        """
        health = self._health[idx]
        if health.state == "dead":
            return float("-inf")
        fab = self.members[idx].fabric
        free = len(fab.free()) / fab.grid.num_tiles
        total = sum(self._window_routed)
        load = (self._window_routed[idx] / total) if total else 0.0
        residents = list(fab.residents.values())
        costs = [fab.download_cost(r.rid) or r.download_cost for r in residents]
        mean_cost = (sum(costs) / len(costs)) if costs else 0.0
        price = (1.0 - free) * mean_cost / (1.0 + mean_cost)
        score = free - 0.5 * load - 0.5 * price
        p50 = self.members[idx].dispatch_hist.percentile(0.5)
        if p50 > 0.0:
            worst = max(m.dispatch_hist.percentile(0.5) for m in self.members)
            if worst > 0.0:
                score -= 0.25 * (p50 / worst)
        if health.state == "quarantined":
            score -= 1.0
        elif health.state == "probation":
            score -= 0.25
        score -= 0.05 * min(health.window_errors, 10)
        return score

    def _best_member(self, exclude: "frozenset[int] | set[int]" = frozenset(),
                     min_free: int = 0) -> int | None:
        """The highest-scoring candidate.  A dead member scores ``-inf``, so
        it is picked only when every candidate is dead: placement degrades
        (a dead member's overlay still serves its fallback) rather than
        fails."""
        best = None
        for i in range(len(self.members)):
            if i in exclude:
                continue
            if min_free and len(self.members[i].fabric.free()) < min_free:
                continue
            score = self._member_score(i)
            if best is None or score > best[0]:
                best = (score, i)
        return None if best is None else best[1]

    # -- routing --------------------------------------------------------------
    def _copy_state(self, rec: _FleetRecord, rep: _Replica) -> str:
        """``live``    — assembled and resident on its member,
        ``pending`` — placed or downloading, not (yet) resident,
        ``dead``    — was resident and lost its PR regions (reclaim/evict)."""
        entry = rep.wrapper._entries.get(rec.sig_key)
        acc = entry.acc if entry is not None else None
        if acc is None:
            return "pending"
        return ("live" if self.members[rep.member_index].resident_current(acc)
                else "dead")

    def _route(self, rec: _FleetRecord) -> _Replica:
        """The least-loaded live copy on a member that is not dead: healthy
        members outrank quarantined and probationary ones, then fewest
        in-flight calls, then fewest lifetime dispatches (equal copies
        alternate).  With no routable live copy the primary serves (its
        member re-downloads or falls back) — unless its member is dead, and
        then any copy on a living member does."""
        replicas = rec.replicas
        primary = replicas[0]
        health = self._health
        if len(replicas) == 1:
            return primary
        best = best_rank = None
        for rep in replicas:
            state = health[rep.member_index].state
            if state == "dead" or self._copy_state(rec, rep) != "live":
                continue
            rank = (0 if state == "healthy" else 1, rep.inflight, rep.routed)
            if best is None or rank < best_rank:
                best, best_rank = rep, rank
        if best is None:
            if health[primary.member_index].state == "dead":
                for rep in replicas:
                    if health[rep.member_index].state != "dead":
                        return rep
            return primary
        if best is not primary and self._copy_state(rec, primary) != "live":
            self.stats.failovers += 1
        return best

    def _dispatch(self, rec: _FleetRecord, args: tuple):
        plan = self.faults
        if plan is not None and plan.member_deaths:
            for idx in plan.members_to_kill(self._dispatches):
                self.kill_member(idx)
        rep = self._route(rec)
        rep.inflight += 1
        try:
            out, failed = rep.wrapper._invoke(args, writeback=False)
        finally:
            rep.inflight -= 1
        if failed:
            # the routed copy's dispatch failed and its member answered from
            # the fallback, leaving the donated inputs as they were: re-serve
            # through another live copy so the answer comes off fabric and
            # the suspect member sheds load
            out = self._retry_dispatch(rec, rep, args, out)
        rep.routed += 1
        rec.hits += 1
        rec.window_hits += 1
        self.stats.routed += 1
        self._window_routed[rep.member_index] += 1
        self._routed_total[rep.member_index] += 1
        self._dispatches += 1
        if self._dispatches % self.window == 0:
            self._rebalance()
        return out

    def _retry_dispatch(self, rec: _FleetRecord, failed: _Replica,
                        args: tuple, fallback_out):
        """Dispatch-failure failover: one other live copy on a member that
        is not dead serves the call, from the caller's unchanged state;
        else the failed member's fallback answer stands, landed in the
        donated inputs here.  Every path returns the same numbers."""
        for rep in rec.replicas:
            if rep is failed or rep.member_index == failed.member_index:
                continue
            if self._health[rep.member_index].state == "dead":
                continue
            if self._copy_state(rec, rep) != "live":
                continue
            self.stats.dispatch_retries += 1
            rep.inflight += 1
            try:
                return rep.wrapper(*args)
            finally:
                rep.inflight -= 1
        entry = failed.wrapper._entries.get(rec.sig_key)
        if entry is None:
            return fallback_out
        dyn = failed.wrapper._split(args)[0]
        return JitAssembled._land(entry, dyn, fallback_out)

    # -- replication controller -----------------------------------------------
    def _rebalance(self) -> None:
        """One watermark pass over every routing record: prune copies that
        died underneath, replicate the hot, drain the cold, reset the window
        counters.  At most once per ``window`` dispatches, on the
        dispatching thread, under the fleet lock."""
        with self._lock:
            self.stats.rebalances += 1
            self._update_health()
            for wrapper in list(self._wrappers):
                for rec in list(wrapper._records.values()):
                    self._rebalance_record(wrapper, rec)
            # replication may have made live copies since the health pass
            # demoted: sweep again, so no quarantined member keeps a primary
            # that has a healthy live stand-in
            for idx, health in enumerate(self._health):
                if health.state == "quarantined":
                    self._demote_member(idx)
            self._window_routed = [0] * len(self.members)
            if self.sanitize:
                from repro_torch.analysis import check as _check

                _check.ensure(_check.check_fleet(self, pruned=True))

    def _rebalance_record(self, wrapper: FleetJitAssembled,
                          rec: _FleetRecord) -> None:
        self._prune_record(rec)
        hits = rec.window_hits
        rec.window_hits = 0
        if hits >= self.replicate_after and len(rec.replicas) < self.max_replicas:
            self._replicate(wrapper, rec)
        elif hits <= self.drain_below and len(rec.replicas) > 1:
            self._teardown_one(rec)

    def _prune_record(self, rec: _FleetRecord) -> None:
        """Drop copies whose residents were reclaimed or evicted member-side.
        A live copy is promoted to primary; if nothing survived, the old
        primary stays (its wrapper re-downloads on the next demand)."""
        states = [(rep, self._copy_state(rec, rep)) for rep in rec.replicas]
        keep = [rep for rep, st in states if st != "dead"]
        if not keep:
            keep = [rec.replicas[0]]
        lost = len(rec.replicas) - len(keep)
        if lost:
            self.stats.replicas_lost += lost
            # stable partition: live copies first (the new primary)
            keep.sort(key=lambda rep: 0 if self._copy_state(rec, rep) == "live" else 1)
            rec.replicas = tuple(keep)

    def _primary_resident(self, rec: _FleetRecord) -> ResidentAccelerator | None:
        primary = rec.replicas[0]
        entry = primary.wrapper._entries.get(rec.sig_key)
        acc = entry.acc if entry is not None else None
        if acc is None:
            return None
        return self.members[primary.member_index].fabric.get(acc.resident_id)

    def _replicate(self, wrapper: FleetJitAssembled, rec: _FleetRecord) -> None:
        """Download one more copy of a hot signature onto the best member
        not hosting it, on that member's LOW lane, displacing no resident: a
        member without the primary's footprint free is skipped."""
        res = self._primary_resident(rec)
        if res is None:
            return                       # primary still downloading: next pass
        hosted = {rep.member_index for rep in rec.replicas}
        hosted |= {i for i, h in enumerate(self._health)
                   if h.state in ("dead", "quarantined")}
        idx = self._best_member(exclude=hosted, min_free=len(res.tiles))
        if idx is None:
            return                       # no member has the headroom
        member_wrapper = wrapper._member_wrapper(idx)
        try:
            member_wrapper.prefetch(*rec.args_spec, low=True, reclaim=False)
        except PlacementError:
            return                       # lost the race for the free tiles
        rec.replicas = rec.replicas + (_Replica(idx, member_wrapper),)
        self.stats.replications += 1

    def _teardown_one(self, rec: _FleetRecord) -> None:
        """Traffic subsided: evict the least-used live replica (never the
        primary slot) and return its tiles and kernels to its member."""
        live = [rep for rep in rec.replicas[1:] if self._copy_state(rec, rep) == "live"]
        if not live:
            return
        victim = min(live, key=lambda rep: rep.routed)
        entry = victim.wrapper._entries.get(rec.sig_key)
        acc = entry.acc if entry is not None else None
        if acc is not None:
            member = self.members[victim.member_index]
            with member._lock:
                if member.resident_current(acc):
                    member._evict_resident(acc.resident_id)
        rec.replicas = tuple(rep for rep in rec.replicas if rep is not victim)
        self.stats.replica_teardowns += 1

    # -- member health: quarantine, death, evacuation -------------------------
    def _member_errors(self, idx: int) -> int:
        """What the health machine samples: every failed dispatch and every
        failed download on that member."""
        stats = self.members[idx].stats
        return stats.dispatch_failures + stats.download_failures

    def _update_health(self) -> None:
        """One health pass per rebalance window (the caller holds the fleet
        lock): each living member's error delta steps its state machine, and
        a quarantined member's primaries are demoted."""
        for idx, health in enumerate(self._health):
            if health.state == "dead":
                continue
            total = self._member_errors(idx)
            delta = total - health.last_seen
            health.last_seen = total
            health.window_errors = delta
            if health.state == "healthy":
                if delta >= self.quarantine_errors:
                    self._quarantine(idx)
            elif health.state == "quarantined":
                if delta == 0:
                    health.clean_windows += 1
                    if health.clean_windows >= self.quarantine_windows:
                        health.state = "probation"
                        health.clean_windows = 0
                else:
                    health.clean_windows = 0
            elif health.state == "probation":
                if delta == 0:
                    health.state = "healthy"
                    self.stats.readmissions += 1
                else:
                    self._quarantine(idx)
            if health.state == "quarantined":
                self._demote_member(idx)

    def _quarantine(self, idx: int) -> None:
        health = self._health[idx]
        health.state = "quarantined"
        health.clean_windows = 0
        self.stats.quarantines += 1
        self._demote_member(idx)

    def _demote_member(self, idx: int) -> None:
        """Move the primary slot off member ``idx`` wherever a live copy
        exists elsewhere.  Sole copies stay: quarantine gates placement and
        routing preference, never availability."""
        for wrapper in list(self._wrappers):
            for rec in list(wrapper._records.values()):
                reps = rec.replicas
                if not reps or reps[0].member_index != idx:
                    continue
                live = [rep for rep in reps[1:]
                        if rep.member_index != idx
                        and self._health[rep.member_index].state != "dead"
                        and self._copy_state(rec, rep) == "live"]
                if not live:
                    continue
                new_primary = live[0]
                rec.replicas = (new_primary,) + tuple(
                    rep for rep in reps if rep is not new_primary)

    def kill_member(self, idx: int) -> None:
        """Declare member ``idx`` dead — by an operator, a test, or the fault
        plan's ``member_deaths``.  Its sole copies are evacuated (a fresh
        download on the best surviving member), its fabric is flushed (its
        residents are gone, as after a host loss), and placement and routing
        avoid it from then on.  Terminal: a dead member never returns."""
        if not 0 <= idx < len(self.members):
            raise ValueError(f"no member {idx} in a fleet of {len(self.members)}")
        with self._lock:
            health = self._health[idx]
            if health.state == "dead":
                return
            health.state = "dead"
            self.stats.member_deaths += 1
            self._evacuate(idx)
            self.members[idx].reconfigure(prefetch=False)
            self._graph_homes = {rid: home for rid, home
                                 in self._graph_homes.items() if home != idx}

    def _evacuate(self, idx: int) -> None:
        """Re-home every record with a copy on dying member ``idx``: a live
        copy elsewhere becomes primary; a sole copy is downloaded again on
        the best surviving member (``stats.evacuations``).  Runs before the
        member's flush, so copy states still read the fabric as it was."""
        for wrapper in list(self._wrappers):
            for rec in list(wrapper._records.values()):
                if not any(rep.member_index == idx for rep in rec.replicas):
                    continue
                off = [rep for rep in rec.replicas if rep.member_index != idx]
                live = [rep for rep in off
                        if self._health[rep.member_index].state != "dead"
                        and self._copy_state(rec, rep) == "live"]
                if live:
                    rec.replicas = tuple(live + [rep for rep in off if rep not in live])
                    continue
                new_idx = self._best_member(exclude={idx})
                if new_idx is None or self._health[new_idx].state == "dead":
                    if off:
                        rec.replicas = tuple(off)
                    continue             # nowhere living to go: re-placed later
                member_wrapper = wrapper._member_wrapper(new_idx)
                try:
                    member_wrapper.prefetch(*rec.args_spec)
                except PlacementError:
                    if off:
                        rec.replicas = tuple(off)
                    continue
                rec.replicas = (_Replica(new_idx, member_wrapper),) + tuple(off)
                self.stats.evacuations += 1

    def health(self) -> list[dict[str, Any]]:
        """Per-member health snapshot (JSON-friendly)."""
        with self._lock:
            return self._health_rows()

    def _health_rows(self) -> list[dict[str, Any]]:
        return [{"member": i, "state": h.state, "errors": h.last_seen,
                 "window_errors": h.window_errors}
                for i, h in enumerate(self._health)]

    def failure_ledger(self) -> dict[str, Any]:
        """Fleet-wide failure accounting: the member ledgers summed, plus the
        fleet layer's own health events (the serving engines surface it)."""
        totals: dict[str, Any] = {}
        for member in self.members:
            for key, value in member.failure_ledger().items():
                totals[key] = totals.get(key, 0) + value
        totals.update(
            quarantines=self.stats.quarantines,
            readmissions=self.stats.readmissions,
            evacuations=self.stats.evacuations,
            member_deaths=self.stats.member_deaths,
            fleet_dispatch_retries=self.stats.dispatch_retries,
            quarantined_members=[i for i, h in enumerate(self._health)
                                 if h.state == "quarantined"],
            dead_members=[i for i, h in enumerate(self._health) if h.state == "dead"],
        )
        return totals

    # -- cross-fabric reclaim preference --------------------------------------
    def _replica_preference(self, idx: int) -> Callable[[ResidentAccelerator], bool]:
        """Member ``idx``'s ``Overlay.reclaim_prefer``: under pressure a
        resident that is a *copy* (another member holds a live resident of
        the same fleet record) goes before any sole copy.  It runs under the
        member lock and reads the fleet records without the fleet lock (the
        replica tuples swap whole), so the lock order member -> fleet never
        arises."""
        def prefer(res: ResidentAccelerator) -> bool:
            return self._has_other_live_copy(idx, res.rid)
        return prefer

    def _has_other_live_copy(self, idx: int, rid: str) -> bool:
        for wrapper in list(self._wrappers):
            for rec in list(wrapper._records.values()):
                mine = other = False
                for rep in rec.replicas:
                    entry = rep.wrapper._entries.get(rec.sig_key)
                    acc = entry.acc if entry is not None else None
                    if acc is None or not self.members[rep.member_index].resident_current(acc):
                        continue
                    if rep.member_index == idx and acc.resident_id == rid:
                        mine = True
                    elif rep.member_index != idx:
                        other = True
                if mine and other:
                    return True
        return False

    # -- trace-based frontend (the Overlay surface) ---------------------------
    def jit(self, fn: Callable[..., Any] | None = None, *,
            strict: bool = False, name: str | None = None,
            static_argnums: tuple[int, ...] = (),
            donate_argnums: tuple[int, ...] = (),
            tile_budget: int | None = None) -> Callable[..., Any]:
        """A plain PyTorch function as a fleet-managed accelerator — the
        contract of :meth:`Overlay.jit`, without tile pinning (``fixed``
        names tiles of one fabric; a fleet places across many)."""
        def wrap(f: Callable[..., Any]) -> FleetJitAssembled:
            return FleetJitAssembled(self, f, strict=strict, name=name,
                                     static_argnums=static_argnums,
                                     donate_argnums=donate_argnums,
                                     tile_budget=tile_budget)
        return wrap if fn is None else wrap(fn)

    def aot(self, fn: Callable[..., Any], *abstract_args,
            strict: bool = False, name: str | None = None,
            tile_budget: int | None = None) -> FleetJitAssembled:
        """Ahead of time: home the signature and pay (or start) its download
        before traffic arrives, as :meth:`Overlay.aot`."""
        jitted = self.jit(fn, strict=strict, name=name, tile_budget=tile_budget)
        jitted.prefetch(*abstract_args)
        return jitted

    def prefetch(self, jitted: FleetJitAssembled, *args):
        """Fleet-level prefetch hint, as :meth:`Overlay.prefetch`."""
        if jitted.fleet is not self:
            raise ValueError("jitted wrapper belongs to a different fleet")
        return jitted.prefetch(*args)

    # -- low-level Graph path -------------------------------------------------
    def assemble(self, graph: Graph, **kwargs: Any):
        """Assemble a hand-built :class:`Graph` on the fleet: the first
        assembly homes the graph on the best-scoring member; later ones go
        to that home while it stays resident (pure residency hits there)."""
        with self._lock:
            rid = self.members[0]._resident_key(graph, graph.input_avals(),
                                                kwargs.get("fixed"))
            home = self._graph_homes.get(rid)
            if home is None or self.members[home].fabric.get(rid) is None:
                home = self._best_member()
                self._graph_homes[rid] = home
                self.stats.placements += 1
            return self.members[home].assemble(graph, **kwargs)

    # -- fabric management ----------------------------------------------------
    def evict(self, target: "Graph | str") -> int:
        """Free an accelerator's PR regions and kernels on EVERY member (by
        graph or name) and drop its routing records, so the next call places
        it afresh.  Returns cache entries removed fleet-wide."""
        name = target.name if isinstance(target, Graph) else str(target)
        with self._lock:
            removed = sum(m.evict(target) for m in self.members)
            for wrapper in list(self._wrappers):
                if wrapper.name == name:
                    wrapper._records.clear()
            for rid in [r for r, h in self._graph_homes.items()
                        if self.members[h].fabric.get(r) is None]:
                del self._graph_homes[rid]
            return removed

    def reconfigure(self, **kwargs: Any) -> dict[str, Any]:
        """Reconfigure every member (the kwargs of
        :meth:`Overlay.reconfigure`).  Routing records survive: copies of
        flushed residents read as pending and download again on demand."""
        with self._lock:
            for member in self.members:
                member.reconfigure(**kwargs)
            self._graph_homes.clear()
        return self.describe()

    def defragment(self) -> int:
        """Defragment every member fabric; returns residents moved."""
        return sum(m.defragment() for m in self.members)

    def drain(self, timeout: float | None = None) -> bool:
        """Barrier over every member's download scheduler (replica downloads
        are ordinary low-lane jobs).  ``timeout`` bounds the WHOLE drain:
        one deadline, each member granted only the time left."""
        deadline = None if timeout is None else time.monotonic() + timeout
        ok = True
        for member in self.members:
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            ok = member.drain(remaining) and ok
        return ok

    def close(self) -> None:
        for member in self.members:
            member.close()

    # -- introspection --------------------------------------------------------
    def describe(self) -> dict[str, Any]:
        """The fleet as JSON: every member's ``describe()`` plus the fleet
        layer — each record's copies (member, resident, primary, state,
        routed), routed dispatches per member and the placement scores."""
        with self._lock:
            records: dict[str, Any] = {}
            replicas_live = 0
            for wrapper in list(self._wrappers):
                for rec in wrapper._records.values():
                    copies = []
                    for i, rep in enumerate(rec.replicas):
                        state = self._copy_state(rec, rep)
                        if state == "live" and i > 0:
                            replicas_live += 1
                        entry = rep.wrapper._entries.get(rec.sig_key)
                        acc = entry.acc if entry is not None else None
                        copies.append({
                            "member": rep.member_index,
                            "rid": None if acc is None else acc.resident_id,
                            "primary": i == 0,
                            "state": state,
                            "routed": rep.routed,
                            "inflight": rep.inflight,
                        })
                    records[rec.label] = {"name": wrapper.name, "hits": rec.hits,
                                          "window_hits": rec.window_hits,
                                          "copies": copies}
            return {
                "members": [m.describe() for m in self.members],
                "store": self.store.describe() if self.store is not None else None,
                "fleet": {
                    "size": len(self.members),
                    "health": self._health_rows(),
                    "window": self.window,
                    "replicate_after": self.replicate_after,
                    "drain_below": self.drain_below,
                    "max_replicas": self.max_replicas,
                    "replicas": replicas_live,
                    "routed_per_member": list(self._routed_total),
                    "scores": [round(self._member_score(i), 4)
                               for i in range(len(self.members))],
                    "dispatch_p50_us": [round(m.dispatch_hist.percentile(0.5), 3)
                                        for m in self.members],
                    "dispatch_p99_us": [round(m.dispatch_hist.percentile(0.99), 3)
                                        for m in self.members],
                    "records": records,
                    **dataclasses.asdict(self.stats),
                },
            }
