"""Placement of DFG operators onto the overlay's 2-D tile grid.

Reproduces the paper's central experiment variable (§II–III): where operators
land on the mesh determines how many *pass-through tiles* (here: copy passes over the
data) data must traverse between producer and consumer.

* ``STATIC``  — operators live at fixed, pre-assigned tiles (the paper's static
  overlay, Fig. 2).  Non-adjacent producers/consumers pay pass-through hops.
* ``DYNAMIC`` — the runtime places cooperating operators in **contiguous**
  tiles (the paper's dynamic overlay): a greedy BFS packing that minimizes the
  total Manhattan edge length, so steady-state routing cost is ~zero.

Heterogeneous tile sizes (paper C5): a configurable fraction of tiles (default
1/4, as in the paper) are LARGE; LARGE-class operators may only be placed on
LARGE tiles.  Placement failure due to class exhaustion is the analogue of the
paper's internal-fragmentation study.

The cost model is used by the controller ISA to emit ROUTE/BYPASS
instructions per hop, and by the interpreter as the number of copy passes
an edge pays (``interpreter.py``).

Port of ``repro/core/placement.py``, framework-free and nearly verbatim,
the cost-model planner's pure pieces (:func:`score_placement` and what it
reads) and the relocation guard :func:`check_assignment` included.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Iterable

from repro_torch.core.graph import Graph, Node
from repro_torch.core.patterns import TileClass


class PlacementPolicy(enum.Enum):
    STATIC = "static"
    DYNAMIC = "dynamic"


Coord = tuple[int, int]


@dataclasses.dataclass(frozen=True)
class TileGrid:
    """rows × cols virtual tiles; a fixed fraction are LARGE-class (paper: 1/4).

    LARGE tiles are interleaved every ``1/large_fraction``-th tile in row-major
    order — mirroring the paper's note that its big-tile layout follows the
    physical DSP-column layout rather than an optimal packing.
    """

    rows: int
    cols: int
    large_fraction: float = 0.25

    def __post_init__(self):
        if self.rows < 1 or self.cols < 1:
            raise ValueError("grid must be at least 1x1")
        if not (0.0 <= self.large_fraction <= 1.0):
            raise ValueError("large_fraction must be in [0, 1]")

    @property
    def num_tiles(self) -> int:
        return self.rows * self.cols

    def coords(self) -> list[Coord]:
        return [(r, c) for r in range(self.rows) for c in range(self.cols)]

    def tile_class(self, coord: Coord) -> TileClass:
        idx = coord[0] * self.cols + coord[1]
        if self.large_fraction == 0.0:
            return TileClass.SMALL
        stride = max(1, round(1.0 / self.large_fraction))
        return TileClass.LARGE if idx % stride == 0 else TileClass.SMALL

    def large_coords(self) -> list[Coord]:
        return [c for c in self.coords() if self.tile_class(c) is TileClass.LARGE]


def manhattan(a: Coord, b: Coord) -> int:
    return abs(a[0] - b[0]) + abs(a[1] - b[1])


def route(a: Coord, b: Coord) -> list[Coord]:
    """Deterministic X-then-Y Manhattan route (exclusive of endpoints) — the
    pass-through tiles data crosses between two placed operators."""
    path: list[Coord] = []
    r, c = a
    step = 1 if b[1] > c else -1
    for cc in range(c + step, b[1] + step, step) if b[1] != c else ():
        path.append((r, cc))
    c = b[1]
    step = 1 if b[0] > r else -1
    for rr in range(r + step, b[0] + step, step) if b[0] != r else ():
        path.append((rr, c))
    return path[:-1] if path and path[-1] == b else path


@dataclasses.dataclass
class Placement:
    """Assignment of DFG op-nodes to tile coordinates + derived routing cost."""

    grid: TileGrid
    policy: PlacementPolicy
    assignment: dict[int, Coord]           # node_id -> tile coord
    edge_hops: dict[tuple[int, int], int]  # edge -> Manhattan hops (0 = co-located)

    @property
    def passthrough(self) -> dict[tuple[int, int], int]:
        """Per-edge pass-through tile count (hops beyond the first link)."""
        return {e: max(h - 1, 0) for e, h in self.edge_hops.items()}

    @property
    def total_passthrough(self) -> int:
        return sum(self.passthrough.values())

    @property
    def total_hops(self) -> int:
        """Total nearest-neighbour hops across all dataflow edges."""
        return sum(self.edge_hops.values())

    def descriptor(self) -> str:
        """Canonical string identity of this placement (node→tile map).
        Keys the cheap per-placement route programs in the two-level
        bitstream cache — kernel artifacts deliberately do NOT include it
        (they are placement-free; see DESIGN.md §6)."""
        return repr(sorted(self.assignment.items()))

    def fragmentation(self, graph: Graph) -> float:
        """Fraction of occupied LARGE tiles holding only SMALL-class ops —
        the paper's internal-fragmentation metric (§II)."""
        large = set(self.grid.large_coords())
        if not large:
            return 0.0
        occupants: dict[Coord, list[TileClass]] = {}
        nodes = {n.node_id: n for n in graph.toposorted()}
        for nid, c in self.assignment.items():
            node = nodes[nid]
            cls = node.op.tile_class if node.op is not None else TileClass.SMALL
            occupants.setdefault(c, []).append(cls)
        occupied_large = [c for c in occupants if c in large]
        if not occupied_large:
            return 0.0
        wasted = sum(1 for c in occupied_large
                     if all(cls is TileClass.SMALL for cls in occupants[c]))
        return wasted / len(occupied_large)


class PlacementError(RuntimeError):
    pass


def _class_ok(node: Node, coord: Coord, grid: TileGrid) -> bool:
    cls = node.op.tile_class if node.op is not None else TileClass.SMALL
    if cls is TileClass.LARGE:
        return grid.tile_class(coord) is TileClass.LARGE
    return True  # SMALL ops may sit on either tile size (paper packs both)


def _edge_costs(graph: Graph, assignment: dict[int, Coord]) -> dict[tuple[int, int], int]:
    """Per-dataflow-edge Manhattan hop counts under an assignment."""
    hops: dict[tuple[int, int], int] = {}
    placed = set(assignment)
    for node in graph.toposorted():
        if node.node_id not in placed:
            continue
        for src in node.inputs:
            if src in placed:
                a, b = assignment[src], assignment[node.node_id]
                hops[(src, node.node_id)] = manhattan(a, b)
    return hops


def place_static(graph: Graph, grid: TileGrid,
                 fixed: dict[int, Coord] | None = None, *,
                 occupied: Iterable[Coord] = (),
                 max_tiles: int | None = None) -> Placement:
    """Static overlay placement: operators at fixed positions.

    With ``fixed`` given (as in the fig-2 scenarios) it is used verbatim —
    but pinning onto a tile held by another resident accelerator is a
    :class:`PlacementError` (the fabric is shared; see ``core/fabric.py``).
    Otherwise op-nodes are assigned round-robin in row-major order over the
    *free* tiles only — the 'operators are wherever they happen to be'
    regime the paper's static overlay suffers from, packed incrementally
    around whatever is already resident.  ``max_tiles`` caps the footprint
    (the round-robin pool) so one accelerator cannot monopolize the fabric.
    """
    occupied = set(occupied)
    ops = graph.op_nodes()
    assignment: dict[int, Coord] = {}
    if fixed is not None:
        for node in ops:
            if node.node_id not in fixed:
                raise PlacementError(f"static placement missing node {node.node_id}")
            coord = fixed[node.node_id]
            if not _class_ok(node, coord, grid):
                raise PlacementError(
                    f"node {node.name!r} (LARGE) pinned to SMALL tile {coord}")
            if coord in occupied:
                raise PlacementError(
                    f"node {node.name!r} pinned to tile {coord} already held "
                    f"by a resident accelerator ({len(occupied)} tiles occupied)")
            assignment[node.node_id] = coord
    else:
        free_all = [c for c in grid.coords() if c not in occupied]
        if not free_all:
            raise PlacementError(
                f"no free tiles for {graph.name!r} on {grid.rows}x{grid.cols} "
                f"grid ({len(occupied)} occupied by resident accelerators)")
        # LARGE availability is computed over ALL free tiles: the footprint
        # cap below is soft for class necessity (mirrors place_dynamic)
        free_large = [c for c in free_all
                      if grid.tile_class(c) is TileClass.LARGE]
        window = free_all if max_tiles is None else free_all[:max(1, max_tiles)]
        large_pool = itertools.cycle(free_large or window)
        all_pool = itertools.cycle(window)
        for node in ops:
            cls = node.op.tile_class if node.op is not None else TileClass.SMALL
            if cls is TileClass.LARGE and not free_large and grid.large_coords():
                # grid has LARGE tiles but none are free: residency pressure
                raise PlacementError(
                    f"no free LARGE tile for {node.name!r} on "
                    f"{grid.rows}x{grid.cols} grid "
                    f"({len(occupied)} tiles occupied)")
            pool = large_pool if cls is TileClass.LARGE else all_pool
            assignment[node.node_id] = next(pool)
    return Placement(grid, PlacementPolicy.STATIC, assignment,
                     _edge_costs(graph, assignment))


def place_dynamic(graph: Graph, grid: TileGrid, *,
                  occupied: Iterable[Coord] = (),
                  max_tiles: int | None = None) -> Placement:
    """Dynamic overlay placement (the paper's contribution, C2).

    Greedy contiguous packing: visit op-nodes in topological order; place each
    node on the free, class-compatible tile that minimizes summed Manhattan
    distance to its already-placed producers (ties broken row-major, so
    chains lay out as pipelines along a row — 'contiguous and pipelined').
    Falls back to sharing one of *this graph's own* tiles when no free tile
    remains (co-located ops cost zero hops, like packing two ops in one PR
    region).

    Multi-tenancy (``core/fabric.py``): ``occupied`` removes tiles held by
    resident accelerators from the free pool, so graphs pack incrementally
    around each other; when a node finds neither a free class-compatible
    tile nor a co-locatable own tile, placement *raises pressure*
    (:class:`PlacementError`) instead of silently overwriting residents —
    the overlay answers by reclaiming LRU residents.  ``max_tiles`` caps
    this graph's footprint (further ops co-locate) so one big accelerator
    does not monopolize the fabric; the cap is soft — it is exceeded only
    when a class-incompatible footprint would otherwise fail (e.g. the
    first LARGE op of a budget-exhausted graph still claims a LARGE tile).
    """
    occupied = set(occupied)
    ops = graph.op_nodes()
    free: list[Coord] = [c for c in grid.coords() if c not in occupied]
    assignment: dict[int, Coord] = {}
    used: set[Coord] = set()
    # the tile of the latest assignment, and of the latest one on a LARGE
    # tile: the reference rescans every assignment for these (O(n^2) in op
    # nodes, seconds for a 4,500-node decode step); the choice is the same
    last_any: Coord | None = None
    last_large: Coord | None = None

    for node in ops:
        producers = [assignment[i] for i in node.inputs if i in assignment]
        cand_all = [c for c in free if _class_ok(node, c, grid)]
        cls = node.op.tile_class if node.op is not None else TileClass.SMALL
        if cls is TileClass.SMALL:
            # avoid fragmenting LARGE tiles with SMALL ops when possible (C5)
            small_only = [c for c in cand_all
                          if grid.tile_class(c) is TileClass.SMALL]
            if small_only:
                cand_all = small_only
        under_budget = max_tiles is None or len(used) < max_tiles
        candidates = cand_all if under_budget else []
        if not candidates:
            # co-locate on one of this graph's own class-compatible tiles
            # (two ops packed into one PR region); class limits still hold
            if producers and _class_ok(node, producers[-1], grid):
                own = producers[-1]
            else:
                own = last_large if cls is TileClass.LARGE else last_any
            if own is not None:
                assignment[node.node_id] = own
                last_any = own
                if grid.tile_class(own) is TileClass.LARGE:
                    last_large = own
                continue
            if cand_all:
                # over budget but no own tile fits this class: claim a free
                # one anyway (soft cap) rather than fail a placeable graph
                candidates = cand_all
            else:
                raise PlacementError(
                    f"no {node.op.tile_class if node.op else 'SMALL'} tile for "
                    f"{node.name!r} on {grid.rows}x{grid.cols} grid "
                    f"(large_fraction={grid.large_fraction}, "
                    f"{len(occupied)} tiles held by resident accelerators)")
        if producers:
            best = min(candidates,
                       key=lambda c: (sum(manhattan(c, p) for p in producers), c))
        else:
            best = candidates[0]
        assignment[node.node_id] = best
        free.remove(best)
        used.add(best)
        last_any = best
        if grid.tile_class(best) is TileClass.LARGE:
            last_large = best

    return Placement(grid, PlacementPolicy.DYNAMIC, assignment,
                     _edge_costs(graph, assignment))


def check_assignment(graph: Graph, grid: TileGrid,
                     placement: Placement) -> None:
    """Validate a (possibly hand-built) placement against the invariants
    ``place()`` guarantees: every op node assigned, coordinates on the grid,
    and LARGE ops only on LARGE tiles.  Raises :class:`PlacementError` —
    the guard for placements entering the fabric from outside the placer
    (``Overlay.relocate``)."""
    nodes = {n.node_id: n for n in graph.toposorted()}
    coords = set(grid.coords())
    for nid, coord in placement.assignment.items():
        node = nodes.get(nid)
        if node is None:
            raise PlacementError(f"assignment names unknown node {nid}")
        if coord not in coords:
            raise PlacementError(
                f"tile {coord} outside the {grid.rows}x{grid.cols} grid")
        if not _class_ok(node, coord, grid):
            raise PlacementError(
                f"node {node.name!r} (LARGE) assigned to SMALL tile {coord}")
    missing = [n.node_id for n in graph.op_nodes()
               if n.node_id not in placement.assignment]
    if missing:
        raise PlacementError(
            f"assignment missing op nodes {missing[:5]}")


# -- cost-model planning ------------------------------------------------------
#
# First-fit packing treats every placement of a graph as equally good and
# every reclaim as equally cheap.  The planner replaces that with candidates
# scored in SECONDS-equivalent cost, combining what the overlay measures:
# per-hop dispatch latency, re-download prices (the fabric's EWMA ledger),
# and how scarce fabric real estate currently is.  The pure pieces live
# here; victim simulation (which needs the fabric) stays in ``overlay.py``.

def placement_crowding(placement: Placement) -> int:
    """Co-location pressure: total ops beyond the first on each tile.  Two
    ops sharing one PR region serialize — the compact candidates the planner
    generates pay for their density here."""
    per_tile: dict[Coord, int] = {}
    for coord in placement.assignment.values():
        per_tile[coord] = per_tile.get(coord, 0) + 1
    return sum(n - 1 for n in per_tile.values() if n > 1)


def placement_footprint(placement: Placement) -> int:
    """Distinct tiles a placement claims."""
    return len(set(placement.assignment.values()))


def candidate_budgets(n_ops: int, max_tiles: int | None = None) -> list[int | None]:
    """Footprint budgets worth scoring for an ``n_ops``-operator graph:
    unconstrained (first-fit's spread), half-packed, and fully co-located.
    All candidates respect a caller-imposed ``max_tiles`` cap."""
    budgets: list[int | None] = [max_tiles]
    for b in ((n_ops + 1) // 2, 1):
        if b >= 1 and (max_tiles is None or b < max_tiles):
            budgets.append(b)
    out: list[int | None] = []
    for b in budgets:
        if b not in out:
            out.append(b)
    return out


def candidate_placements(graph: Graph, grid: TileGrid, policy: PlacementPolicy,
                         fixed: dict[int, Coord] | None = None, *,
                         occupied: Iterable[Coord] = (),
                         max_tiles: int | None = None) -> list[Placement]:
    """Feasible placements at several footprint budgets (deduplicated by
    descriptor).  Empty when nothing fits — the overlay then simulates
    reclaims.  STATIC policy with pinned tiles has exactly one candidate."""
    occupied = set(occupied)
    if policy is PlacementPolicy.STATIC and fixed is not None:
        try:
            return [place_static(graph, grid, fixed, occupied=occupied,
                                 max_tiles=max_tiles)]
        except PlacementError:
            return []
    n_ops = len(graph.op_nodes())
    out: list[Placement] = []
    seen: set[str] = set()
    for budget in candidate_budgets(n_ops, max_tiles):
        try:
            p = place(graph, grid, policy, fixed, occupied=occupied,
                      max_tiles=budget)
        except PlacementError:
            continue
        desc = p.descriptor()
        if desc not in seen:
            seen.add(desc)
            out.append(p)
    return out


def score_placement(placement: Placement, *,
                    hop_cost_s: float,
                    crowd_cost_s: float,
                    occupied_tiles: int,
                    num_tiles: int,
                    tile_pressure_s: float,
                    victims_seconds: float = 0.0) -> float:
    """Seconds-equivalent cost of adopting ``placement``.

    ``victims_seconds``
        total modeled re-download price of the residents that must be
        reclaimed to make this placement feasible (0 when it fits as-is),
    ``hop_cost_s`` × total route hops
        steady-state routing penalty per dispatch horizon,
    ``crowd_cost_s`` × :func:`placement_crowding`
        serialization penalty of co-located operators,
    footprint × (occupancy-after / tiles)² × ``tile_pressure_s``
        opportunity cost of claiming scarce real estate: on an empty fabric
        spreading out is free, near saturation every extra tile claimed is
        a future reclaim someone else pays for.
    """
    footprint = placement_footprint(placement)
    after = min(occupied_tiles + footprint, num_tiles)
    pressure = (after / num_tiles) ** 2 if num_tiles else 0.0
    return (victims_seconds
            + hop_cost_s * placement.total_hops
            + crowd_cost_s * placement_crowding(placement)
            + tile_pressure_s * footprint * pressure)


def place(graph: Graph, grid: TileGrid, policy: PlacementPolicy,
          fixed: dict[int, Coord] | None = None, *,
          occupied: Iterable[Coord] = (),
          max_tiles: int | None = None) -> Placement:
    """Place ``graph`` into the *free* portion of ``grid``.

    ``occupied`` is the set of tiles currently held by resident accelerators
    (``Fabric.occupied()``); both policies pack incrementally around it and
    raise :class:`PlacementError` when the graph cannot fit — the overlay's
    cue to reclaim residents.  ``max_tiles`` bounds this graph's footprint.
    """
    graph.validate()
    if policy is PlacementPolicy.STATIC:
        return place_static(graph, grid, fixed, occupied=occupied,
                            max_tiles=max_tiles)
    return place_dynamic(graph, grid, occupied=occupied, max_tiles=max_tiles)
