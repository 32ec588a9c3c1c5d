"""Pure invariant checkers for the overlay runtime.

Every function here *reads* runtime state and returns a list of
:class:`Violation` — no mutation, no locking (callers that need a
consistent snapshot hold the owning lock; the sanitizer hooks do).  The
rule names are stable identifiers: tests, the sanitizer, and the
``python -m repro_torch.analysis report`` audit all key on them.

Rule catalog
------------

Fabric ledger (``check_fabric``):

* ``fabric/key-mismatch``     — ledger key differs from ``res.rid``
* ``fabric/dead-resident``    — a released resident still in the ledger
* ``fabric/tile-bounds``      — resident claims a coord outside the grid
* ``fabric/tile-overlap``     — two residents claim the same tile
* ``fabric/placement-tiles``  — ``res.tiles`` disagrees with the
  placement's node→tile assignment
* ``fabric/occupants``        — per-tile occupant map keys ≠ tiles
* ``fabric/generation-monotone`` — generation counters violate
  ``1 ≤ admit_generation ≤ generation ≤ fabric generation``

Compiled entries vs ISA programs (``check_residency``):

* ``entry/routes-length``     — routes vector length ≠ graph edge count
* ``entry/hop-bounds``        — a hop count outside ``[0, rows+cols-2]``
* ``entry/route-cost``        — cached ``route_cost`` ≠ sum of hops
* ``entry/zero-hop``          — ``zero_hop`` flag disagrees with hops
* ``entry/spec-tier``         — tier bookkeeping broken (unknown tier, or
  ``specialized`` without a compiled ``spec_fn`` / with a pending build)

Failure handling (``check_breakers``, part of ``check_overlay``):

* ``entry/breaker-state``     — a breaker in a state other than
  ``closed``/``open``
* ``entry/breaker-fallback``  — a breaker-open entry with neither a traced
  fallback closure nor a previously assembled accelerator: nothing can
  serve its calls (zero-drop degradation broken)

Bitstream cache side tables (``check_cache``):

* ``cache/route-owner``       — a route program's owner is not a resident,
  or its placement descriptor is stale
* ``cache/spec-orphan``       — a specialized executable whose generic
  kernel artifact is gone from the store

Fleet replica records (``check_fleet``):

* ``fleet/replica-empty``     — a record with no replicas
* ``fleet/replica-index``     — replica names a member outside the fleet
* ``fleet/replica-dup``       — two replicas of one record on one member
* ``fleet/replica-count``     — more replicas than ``max_replicas``
* ``fleet/dead-replica``      — (``pruned=True`` only) a dead copy that
  pruning should have dropped — dead *sole primaries* are legal (they
  re-download on demand)
* ``fleet/home-index``        — a graph-home entry naming no member
* ``fleet/health-size``       — health ledger out of step with the member
  list, or a member in an unknown health state
* ``fleet/quarantined-primary`` — a record's primary sits on a quarantined
  (or dead) member while a live copy exists on a healthy one — demotion
  should have moved the primary slot

``describe()`` schema (``check_overlay_describe`` /
``check_fleet_describe``): ``describe/*`` — the JSON key structure
dashboards and the planner consume drifted.  The frozen key sets are the
reference's: ``mesh`` adds no key to ``describe()`` there (it changes
kernel keys, not the report), so the port's sets equal them
(``tests/test_torch_analysis.py`` compares them).

Port of ``repro/analysis/check.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = [
    "InvariantError", "Violation", "ensure",
    "check_fabric", "check_residency", "check_cache", "check_breakers",
    "check_overlay", "check_fleet", "check_overlay_describe",
    "check_fleet_describe",
]


class InvariantError(AssertionError):
    """A runtime invariant broke; ``rule`` names the violated rule."""

    def __init__(self, rule: str, message: str) -> None:
        super().__init__(f"{rule}: {message}")
        self.rule = rule
        self.message = message


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    message: str

    def to_error(self) -> InvariantError:
        return InvariantError(self.rule, self.message)


def ensure(violations: list[Violation]) -> None:
    """Raise the first violation (the sanitizer's entry point)."""
    if violations:
        raise violations[0].to_error()


# ---------------------------------------------------------------------------
# fabric ledger
# ---------------------------------------------------------------------------
def check_fabric(fabric: Any) -> list[Violation]:
    out: list[Violation] = []
    grid_coords = set(fabric.grid.coords())
    claimed: dict[tuple, str] = {}
    residents = fabric.residents
    for key, res in residents.items():
        if key != res.rid:
            out.append(Violation(
                "fabric/key-mismatch",
                f"ledger key {key!r} holds resident rid {res.rid!r}"))
        if not res.live:
            out.append(Violation(
                "fabric/dead-resident",
                f"{res.rid}: live=False but still in the ledger"))
        stray = res.tiles - grid_coords
        if stray:
            out.append(Violation(
                "fabric/tile-bounds",
                f"{res.rid}: tiles {sorted(stray)} outside the "
                f"{fabric.grid.rows}x{fabric.grid.cols} grid"))
        for tile in res.tiles:
            other = claimed.get(tile)
            if other is not None:
                out.append(Violation(
                    "fabric/tile-overlap",
                    f"tile {tile} claimed by both {other} and {res.rid}"))
            claimed[tile] = res.rid
        assigned = frozenset(res.placement.assignment.values())
        if assigned != res.tiles:
            out.append(Violation(
                "fabric/placement-tiles",
                f"{res.rid}: ledger tiles {sorted(res.tiles)} != placement "
                f"assignment {sorted(assigned)}"))
        if set(res.occupants) != set(res.tiles):
            out.append(Violation(
                "fabric/occupants",
                f"{res.rid}: occupant map covers "
                f"{sorted(res.occupants)} but tiles are "
                f"{sorted(res.tiles)}"))
        if not (1 <= res.admit_generation <= res.generation
                <= fabric._generation):
            out.append(Violation(
                "fabric/generation-monotone",
                f"{res.rid}: admit_generation={res.admit_generation} "
                f"generation={res.generation} "
                f"fabric generation={fabric._generation}"))
    return out


# ---------------------------------------------------------------------------
# compiled entries vs ISA programs
# ---------------------------------------------------------------------------
def check_residency(overlay: Any) -> list[Violation]:
    from repro_torch.core import interpreter as interp

    out: list[Violation] = []
    max_hop = overlay.grid.rows + overlay.grid.cols - 2
    for res in overlay.fabric.residents.values():
        if res.tier not in ("generic", "specialized"):
            out.append(Violation(
                "entry/spec-tier", f"{res.rid}: unknown tier {res.tier!r}"))
        if res.tier == "specialized":
            if res.spec_fn is None:
                out.append(Violation(
                    "entry/spec-tier",
                    f"{res.rid}: tier=specialized with no compiled "
                    f"spec_fn"))
            if res.spec_pending:
                out.append(Violation(
                    "entry/spec-tier",
                    f"{res.rid}: tier=specialized while a specialize "
                    f"build is still pending"))
        if res.routes is None:
            continue                  # relocated, not rebound yet: no vector
        n_edges = len(res.graph.edges())
        n_routes = int(res.routes.shape[0]) if res.routes.ndim else 0
        if n_routes != n_edges:
            out.append(Violation(
                "entry/routes-length",
                f"{res.rid}: routes vector has {n_routes} entries for "
                f"{n_edges} graph edges"))
            continue
        hops = interp.route_hops(res.graph, res.placement)
        bad = [h for h in hops if not 0 <= h <= max_hop]
        if bad:
            out.append(Violation(
                "entry/hop-bounds",
                f"{res.rid}: hop counts {bad} outside [0, {max_hop}]"))
        if res.route_cost != sum(hops):
            out.append(Violation(
                "entry/route-cost",
                f"{res.rid}: route_cost={res.route_cost} but placement "
                f"hops sum to {sum(hops)}"))
        if res.zero_hop != interp.zero_hop(hops):
            out.append(Violation(
                "entry/zero-hop",
                f"{res.rid}: zero_hop={res.zero_hop} but hops are "
                f"{hops}"))
    return out


# ---------------------------------------------------------------------------
# bitstream cache side tables
# ---------------------------------------------------------------------------
def check_cache(overlay: Any) -> list[Violation]:
    out: list[Violation] = []
    cache = overlay.cache
    residents = overlay.fabric.residents
    for key in cache._routes:
        owner, _, desc = key.partition("|")
        res = residents.get(owner)
        if res is None:
            out.append(Violation(
                "cache/route-owner",
                f"route program for {owner!r} but no such resident"))
        elif desc != res.placement.descriptor():
            out.append(Violation(
                "cache/route-owner",
                f"route program for {owner!r} keyed to a stale placement "
                f"descriptor"))
    for key in cache._specialized:
        kernel, _, _ = key.partition("|spec|")
        if kernel not in cache._store:
            out.append(Violation(
                "cache/spec-orphan",
                f"specialized executable {key!r} outlived its generic "
                f"kernel artifact {kernel!r}"))
    return out


# ---------------------------------------------------------------------------
# failure handling: circuit breakers
# ---------------------------------------------------------------------------
def check_breakers(overlay: Any) -> list[Violation]:
    """Zero-drop degradation invariants: a breaker-open
    entry is pinned to its fallback, so it must still HAVE one — the
    traced fallback closure or a previously assembled accelerator."""
    out: list[Violation] = []
    for wrapper in list(overlay._wrappers):
        for key, entry in list(wrapper._entries.items()):
            if entry.breaker not in ("closed", "open"):
                out.append(Violation(
                    "entry/breaker-state",
                    f"{wrapper.name} entry {key!r}: unknown breaker state "
                    f"{entry.breaker!r}"))
                continue
            if entry.breaker == "open" and entry.closed is None \
                    and entry.acc is None:
                out.append(Violation(
                    "entry/breaker-fallback",
                    f"{wrapper.name} entry {key!r}: breaker open with no "
                    f"fallback closure and no assembled accelerator"))
    return out


def check_overlay(overlay: Any) -> list[Violation]:
    """All single-overlay invariants; caller holds ``overlay._lock`` when
    the overlay is shared (the sanitizer hooks do)."""
    return (check_fabric(overlay.fabric)
            + check_residency(overlay)
            + check_cache(overlay)
            + check_breakers(overlay))


# ---------------------------------------------------------------------------
# fleet replica records
# ---------------------------------------------------------------------------
def check_fleet(fleet: Any, *, pruned: bool = False) -> list[Violation]:
    """Fleet-level invariants; the caller holds ``fleet._lock``.  With
    ``pruned=True`` (valid right after a rebalance) dead non-primary copies
    are violations too."""
    out: list[Violation] = []
    n = len(fleet.members)
    for wrapper in list(fleet._wrappers):
        for rec in wrapper._records.values():
            if not rec.replicas:
                out.append(Violation("fleet/replica-empty", f"{rec.label}: no replicas"))
                continue
            if len(rec.replicas) > fleet.max_replicas:
                out.append(Violation(
                    "fleet/replica-count",
                    f"{rec.label}: {len(rec.replicas)} replicas > "
                    f"max_replicas={fleet.max_replicas}"))
            seen: set[int] = set()
            for i, rep in enumerate(rec.replicas):
                if not 0 <= rep.member_index < n:
                    out.append(Violation(
                        "fleet/replica-index",
                        f"{rec.label}: replica on member {rep.member_index} "
                        f"of a {n}-member fleet"))
                    continue
                if rep.member_index in seen:
                    out.append(Violation(
                        "fleet/replica-dup",
                        f"{rec.label}: two replicas on member {rep.member_index}"))
                seen.add(rep.member_index)
                if pruned and fleet._copy_state(rec, rep) == "dead" \
                        and (i > 0 or len(rec.replicas) > 1):
                    out.append(Violation(
                        "fleet/dead-replica",
                        f"{rec.label}: dead copy on member {rep.member_index} "
                        f"survived pruning"))
    for rid, home in fleet._graph_homes.items():
        if not 0 <= home < n:
            out.append(Violation(
                "fleet/home-index",
                f"graph home for {rid!r} names member {home} of a {n}-member fleet"))
    out += _check_fleet_health(fleet)
    return out


_HEALTH_STATES = frozenset({"healthy", "probation", "quarantined", "dead"})


def _check_fleet_health(fleet: Any) -> list[Violation]:
    out: list[Violation] = []
    n = len(fleet.members)
    health = fleet._health
    if len(health) != n:
        out.append(Violation("fleet/health-size",
                             f"{len(health)} health entries for {n} members"))
        return out
    for i, h in enumerate(health):
        if h.state not in _HEALTH_STATES:
            out.append(Violation("fleet/health-size",
                                 f"member {i}: unknown health state {h.state!r}"))
    for wrapper in list(fleet._wrappers):
        for rec in wrapper._records.values():
            if not rec.replicas:
                continue                   # fleet/replica-empty covers it
            primary = rec.replicas[0]
            if not 0 <= primary.member_index < n:
                continue                   # fleet/replica-index covers it
            if health[primary.member_index].state not in ("quarantined", "dead"):
                continue
            for rep in rec.replicas[1:]:
                if not 0 <= rep.member_index < n:
                    continue
                if health[rep.member_index].state in ("quarantined", "dead"):
                    continue
                if fleet._copy_state(rec, rep) == "live":
                    out.append(Violation(
                        "fleet/quarantined-primary",
                        f"{rec.label}: primary on "
                        f"{health[primary.member_index].state} member "
                        f"{primary.member_index} while member "
                        f"{rep.member_index} holds a live copy"))
                    break
    return out


# ---------------------------------------------------------------------------
# describe() schema stability
# ---------------------------------------------------------------------------
_OVERLAY_DESCRIBE_KEYS = frozenset({
    "grid", "large_tiles", "policy", "cache", "cached_bitstreams",
    "route_programs", "routes", "specialization", "fabric",
    "dispatch_latency", "route_cost", "assemblies", "reconfigurations",
    "traces", "trace_seconds", "downloads", "evictions", "reclaims",
    "defrags", "relocations", "defrag_failures", "async_downloads",
    "cost_aware_reclaim", "prefetches", "prefetch_hits", "fallback_calls",
    "stale_downloads", "scheduler", "failures", "faults", "store",
    "cost_model_placement", "autotune_thresholds", "defrag_threshold",
})
_FABRIC_DESCRIBE_KEYS = frozenset({
    "tiles", "tiles_used", "tiles_free", "utilization", "fragmentation",
    "residents",
})
_RESIDENT_DESCRIBE_KEYS = frozenset({
    "name", "tiles", "downloads", "download_cost", "relocations", "tier",
    "zero_hop", "specializing", "last_used", "route_cost",
    "dispatch_latency", "dispatch_failures",
})
_SPEC_EXTRA_KEYS = frozenset({"specialized_artifacts", "auto",
                              "specialize_after"})
_FLEET_DESCRIBE_KEYS = frozenset({
    "size", "health", "window", "replicate_after", "drain_below",
    "max_replicas", "replicas", "routed_per_member", "scores",
    "dispatch_p50_us", "dispatch_p99_us", "records",
})
_FLEET_COPY_KEYS = frozenset({"member", "rid", "primary", "state",
                              "routed", "inflight"})


def _key_diff(rule: str, where: str, got: set, want: frozenset
              ) -> list[Violation]:
    missing, extra = sorted(want - got), sorted(got - want)
    if not missing and not extra:
        return []
    return [Violation(rule, f"{where}: missing keys {missing}, "
                            f"unexpected keys {extra}")]


def check_overlay_describe(overlay: Any) -> list[Violation]:
    """``Overlay.describe()`` keeps the schema dashboards rely on."""
    d = overlay.describe()
    out = _key_diff("describe/overlay-schema", "describe()",
                    set(d), _OVERLAY_DESCRIBE_KEYS)
    fab = d.get("fabric")
    if isinstance(fab, dict):             # absent/mistyped: already flagged
        out += _key_diff("describe/fabric-schema", "describe()['fabric']",
                         set(fab), _FABRIC_DESCRIBE_KEYS)
        for rid, rd in fab.get("residents", {}).items():
            out += _key_diff("describe/resident-schema",
                             f"describe() resident {rid!r}",
                             set(rd), _RESIDENT_DESCRIBE_KEYS)
    else:
        out.append(Violation("describe/fabric-schema",
                             "describe()['fabric'] is not a dict"))
    spec_want = frozenset(dataclasses.asdict(overlay.cache.spec_stats)) \
        | _SPEC_EXTRA_KEYS
    out += _key_diff("describe/spec-schema", "describe()['specialization']",
                     set(d.get("specialization", {})), spec_want)
    cache_want = frozenset(dataclasses.asdict(overlay.cache.stats))
    out += _key_diff("describe/cache-schema", "describe()['cache']",
                     set(d.get("cache", {})), cache_want)
    if not isinstance(d.get("scheduler"), dict):
        out.append(Violation("describe/overlay-schema",
                             "describe()['scheduler'] is not a dict"))
    return out


def check_fleet_describe(fleet: Any) -> list[Violation]:
    """``FleetOverlay.describe()`` keeps its schema too."""
    d = fleet.describe()
    out = _key_diff("describe/fleet-schema", "describe()",
                    set(d), frozenset({"members", "fleet", "store"}))
    want = _FLEET_DESCRIBE_KEYS | frozenset(dataclasses.asdict(fleet.stats))
    flt = d.get("fleet") if isinstance(d.get("fleet"), dict) else {}
    out += _key_diff("describe/fleet-schema", "describe()['fleet']", set(flt), want)
    for label, rec in flt.get("records", {}).items():
        out += _key_diff("describe/fleet-record-schema", f"fleet record {label!r}",
                         set(rec), frozenset({"name", "hits", "window_hits", "copies"}))
        for copy in rec["copies"]:
            out += _key_diff("describe/fleet-copy-schema", f"fleet record {label!r} copy",
                             set(copy), _FLEET_COPY_KEYS)
    if len(d.get("members", ())) != len(fleet.members):
        out.append(Violation(
            "describe/fleet-schema",
            f"{len(d['members'])} member reports for {len(fleet.members)} members"))
    return out
