"""Relocation, the cost-model planner and the serving engine's fabric
controls of the port against the JAX package.

Scripted admit / evict / defragment / repack / relocate /
``reconfigure(relocate=True)`` sequences run on both packages' overlays
through the Graph-level API (``Overlay.assemble``), on the same hand-built
graphs (the canned ones and graphs drawn from a numpy seed); every resident's
placement, route vector, relocation and download counts, and the overlays'
counters must be equal after every step.  The JAX tracer cannot run on the
installed jax (``repro/core/trace.py:127``), so the reference's jit-level
tests fail here; their assertions are mirrored against the port's own jit
path below.
"""

import dataclasses
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.core import Overlay as JOverlay
from repro.core import graph as jgraph
from repro.core import interpreter as jinterp
from repro.core import patterns as jpat
from repro.core import placement as jplace
from repro_torch.configs import smoke_config
from repro_torch.core import (FabricError, Overlay, PlacementError,
                              PlacementPolicy, TileGrid, check_assignment,
                              compile_graph, graph as tgraph,
                              interpreter as tinterp, patterns as tpat, place,
                              placement as tplace, saxpy_graph,
                              vmul_reduce_graph)
from repro_torch.models import params as tparams
from repro_torch.serving.engine import Request, ServeEngine

N = 64


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# ---------------------------------------------------------------------------
# graphs built the same way in both packages
# ---------------------------------------------------------------------------
UNARY = ("abs", "relu", "sigmoid", "neg", "sin", "cos", "tanh", "exp")
BINARY = ("add", "sub", "mul", "max", "min")


def recipe(seed: int) -> tuple:
    """A random DAG as a package-free recipe: (inputs, steps, reduce?)."""
    rng = np.random.default_rng(seed)
    n_in = int(rng.integers(1, 3))
    steps, n_vals = [], n_in
    for _ in range(int(rng.integers(3, 9))):
        if n_vals >= 2 and rng.random() < 0.5:
            i, j = (int(v) for v in rng.choice(n_vals, size=2, replace=False))
            steps.append(("b", BINARY[int(rng.integers(len(BINARY)))], i, j))
        else:
            steps.append(("u", UNARY[int(rng.integers(len(UNARY)))],
                          int(rng.integers(n_vals))))
        n_vals += 1
    return n_in, tuple(steps), bool(rng.random() < 0.4)


def build(pkg: str, rec: tuple, name: str, n: int = N):
    """``rec`` as a Graph of the JAX package (``pkg == "jax"``) or the port."""
    graph_mod, pat, dtype = ((jgraph, jpat, jnp.float32) if pkg == "jax"
                             else (tgraph, tpat, torch.float32))
    n_in, steps, reduce = rec
    g = graph_mod.Graph(name)
    vals = [g.input(f"x{i}", (n,), dtype) for i in range(n_in)]
    for st in steps:
        op = pat.LIBRARY[st[1]]
        vals.append(g.apply(op, *(vals[i] for i in st[2:])))
    out = vals[-1]
    if reduce:
        out = g.apply(pat.make_reduce(pat.ADD), out)
    g.output(out)
    return g


def canned(pkg: str, kind: str, name: str):
    graph_mod = jgraph if pkg == "jax" else tgraph
    g = {"vmul": lambda: graph_mod.vmul_reduce_graph(N),
         "saxpy": lambda: graph_mod.saxpy_graph(N, 3.0),
         "branchy": lambda: graph_mod.branchy_graph(N)}[kind]()
    g.name = name
    return g


def graphs(pkg: str, seed: int) -> dict:
    """Six uniquely named graphs: the three canned ones, three drawn."""
    out = {k: canned(pkg, k, k) for k in ("vmul", "saxpy", "branchy")}
    for i in range(3):
        out[f"r{i}"] = build(pkg, recipe(1000 * seed + i), f"r{i}")
    return out


# ---------------------------------------------------------------------------
# scripted sequences on both overlays
# ---------------------------------------------------------------------------
COSTS = {"vmul": 2.0, "saxpy": 0.5, "branchy": 1.0, "r0": 3.0, "r1": 0.25, "r2": 1.5}


def _rid(ov, name):
    rids = [r.rid for r in ov.fabric.residents.values() if r.name == name]
    return rids[0] if rids else None


def _pin_costs(ov):
    """Set every resident's download cost to the script's price: the two
    packages measure different build times, and the planner reads them."""
    for res in ov.fabric.residents.values():
        ov.fabric._download_costs[res.rid] = COSTS[res.name]
        res.download_cost = COSTS[res.name]


def _apply(pkg, ov, gs, action):
    """One scripted step; returns what it returned (or the error type)."""
    kind, *args = action
    policy = jplace.PlacementPolicy if pkg == "jax" else PlacementPolicy
    placer = jplace.place if pkg == "jax" else place
    try:
        if kind == "admit":
            ov.assemble(gs[args[0]], tile_budget=args[1])
            _pin_costs(ov)
            return None
        if kind == "evict":
            return ov.evict(args[0])
        if kind == "defrag":
            return ov.defragment()
        if _rid(ov, args[0] if args else "") is None and kind in ("repack", "relocate"):
            return "absent"
        if kind == "repack":
            return ov.repack(_rid(ov, args[0]), args[1])
        if kind == "relocate":
            res = ov.fabric.get(_rid(ov, args[0]))
            pl = placer(res.graph, ov.grid, ov.policy,
                        occupied=ov.fabric.occupied(), max_tiles=res.tile_budget)
            return ov.relocate(args[0], pl).relocations
        if kind == "reconfigure":
            pol = getattr(policy, args[0]) if args[0] else None
            ov.reconfigure(policy=pol, large_fraction=args[1], relocate=True)
            return None
    except (PlacementError, jplace.PlacementError) as exc:
        return type(exc).__name__
    raise ValueError(kind)


def _state(ov, interp):
    residents = {}
    for res in ov.fabric.residents.values():
        residents[res.name] = (
            sorted(res.placement.assignment.items()), sorted(res.tiles),
            res.placement.policy.value,
            tuple(interp.route_hops(res.graph, res.placement)),
            np.asarray(res.routes).tolist(), res.relocations, res.downloads,
            res.tile_budget, res.tier, res.zero_hop, res.route_cost)
    st = ov.stats
    counters = (st.downloads, st.relocations, st.reclaims, st.defrags,
                st.evictions, st.defrag_failures, st.reconfigurations,
                st.assemblies, ov.cache.stats.insertions,
                ov.cache.stats.evictions, ov.cache.route_stats.emitted,
                ov.cache.route_programs(), len(ov.cache))
    return residents, counters


SCRIPTS = {
    "defrag_after_evict": (dict(rows=3, cols=3), [
        ("admit", "vmul", None), ("admit", "saxpy", None), ("admit", "r0", 2),
        ("admit", "branchy", 2), ("evict", "saxpy"), ("defrag",),
        ("admit", "r1", 2), ("evict", "vmul"), ("defrag",), ("defrag",)]),
    "budget_repacks": (dict(rows=3, cols=3), [
        ("admit", "saxpy", None), ("admit", "saxpy", 1), ("admit", "r1", 4),
        ("repack", "r1", 1), ("repack", "r1", 2), ("repack", "r1", 2),
        ("admit", "r2", 2), ("evict", "saxpy"), ("repack", "r2", 4),
        ("admit", "r1", 3), ("defrag",)]),
    "reconfigure_relocate": (dict(rows=3, cols=3), [
        ("admit", "vmul", None), ("admit", "saxpy", None), ("admit", "r0", 2),
        ("reconfigure", "STATIC", None), ("admit", "branchy", 2),
        ("reconfigure", "DYNAMIC", None), ("reconfigure", None, 0.0),
        ("admit", "r2", 2)]),
    "pressure_and_moves": (dict(rows=2, cols=3), [
        ("admit", "r0", None), ("admit", "vmul", None), ("admit", "r1", None),
        ("admit", "saxpy", 1), ("relocate", "saxpy"), ("admit", "branchy", 1),
        ("admit", "r2", 2), ("relocate", "r2"), ("evict", "r2"), ("defrag",),
        ("admit", "r0", 1)]),
    "cost_model": (dict(rows=3, cols=3, cost_model_placement=True), [
        ("admit", "r0", None), ("admit", "vmul", None), ("admit", "saxpy", None),
        ("admit", "branchy", 2), ("admit", "r1", None), ("admit", "r2", 2),
        ("admit", "vmul", None), ("admit", "r0", 2), ("evict", "saxpy"),
        ("admit", "saxpy", None)]),
    "cost_model_rotation": (dict(rows=2, cols=2, cost_model_placement=True), [
        ("admit", "r0", None), ("admit", "saxpy", None), ("admit", "vmul", None),
        ("admit", "r1", None), ("admit", "branchy", None), ("admit", "r2", None),
        ("admit", "r0", None), ("admit", "saxpy", None), ("admit", "vmul", None),
        ("admit", "r1", None), ("admit", "branchy", None), ("admit", "r2", None)]),
    # a rotation longer than the fabric: the planner's churn detector flips
    # its victim choice to the most recently used resident
    "cost_model_churn": (dict(rows=2, cols=3, cost_model_placement=True),
                         [("admit", n, None) for n in ("r1", "r2", "branchy") * 3]),
    "auto_defrag_cost_aware": (dict(rows=2, cols=2, auto_defragment=True,
                                    cost_aware_reclaim=True), [
        ("admit", "r0", 1), ("admit", "saxpy", 1), ("admit", "vmul", 1),
        ("admit", "r1", 2), ("admit", "r2", None), ("admit", "saxpy", 1),
        ("admit", "branchy", None), ("admit", "r0", 1)]),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_scripted_sequence_matches_jax(script, seed):
    """Every step leaves both fabrics identical: placements, tiles, route
    vectors, relocations, downloads, and the overlays' counters."""
    kwargs, steps = SCRIPTS[script]
    jov, tov = JOverlay(**kwargs), Overlay(**kwargs)
    jgs, tgs = graphs("jax", seed), graphs("torch", seed)
    for i, action in enumerate(steps):
        got_j = _apply("jax", jov, jgs, action)
        got_t = _apply("torch", tov, tgs, action)
        assert got_t == got_j, (i, action)
        assert _state(tov, tinterp) == _state(jov, jinterp), (i, action)
    assert tov.stats.relocations + tov.stats.reclaims > 0   # the script moved something


# ---------------------------------------------------------------------------
# the planner's pure pieces and the cost-model choice
# ---------------------------------------------------------------------------
def _occupancy(seed: int, grid: TileGrid) -> set:
    rng = np.random.default_rng(seed)
    coords = grid.coords()
    k = int(rng.integers(0, len(coords) - 2))
    return {coords[int(i)] for i in rng.choice(len(coords), size=k, replace=False)}


@pytest.mark.parametrize("seed", range(8))
def test_planner_scores_and_choice_match_jax(seed):
    rec = recipe(seed + 50)
    tg, jg = build("torch", rec, "g"), build("jax", rec, "g")
    tgrid, jgrid = TileGrid(3, 3), jplace.TileGrid(3, 3)
    occ = _occupancy(seed, tgrid)
    for max_tiles in (None, 2):
        tc = tplace.candidate_placements(tg, tgrid, PlacementPolicy.DYNAMIC,
                                         occupied=occ, max_tiles=max_tiles)
        jc = jplace.candidate_placements(jg, jgrid, jplace.PlacementPolicy.DYNAMIC,
                                         occupied=occ, max_tiles=max_tiles)
        assert [p.assignment for p in tc] == [p.assignment for p in jc]
        kw = dict(hop_cost_s=1e-4, crowd_cost_s=2e-4, occupied_tiles=len(occ),
                  num_tiles=9, tile_pressure_s=0.7, victims_seconds=0.1 * seed)
        ts = [tplace.score_placement(p, **kw) for p in tc]
        js = [jplace.score_placement(p, **kw) for p in jc]
        np.testing.assert_allclose(ts, js, rtol=0, atol=1e-12)
        assert [tplace.placement_crowding(p) for p in tc] == \
            [jplace.placement_crowding(p) for p in jc]
        assert [tplace.placement_footprint(p) for p in tc] == \
            [jplace.placement_footprint(p) for p in jc]
        if tc:
            assert int(np.argmin(ts)) == int(np.argmin(js))
    # the overlay's plan() packs around the same occupancy
    tov, jov = Overlay(3, 3), JOverlay(3, 3)
    try:
        jpl, jprog = jov.plan(jg, occupied=occ)
    except jplace.PlacementError:
        with pytest.raises(PlacementError):
            tov.plan(tg, occupied=occ)
        return
    tpl, tprog = tov.plan(tg, occupied=occ)
    assert tpl.assignment == jpl.assignment
    assert tprog.mix() == jprog.mix()


@pytest.mark.parametrize("seed", range(4))
def test_place_dynamic_colocation_matches_jax(seed):
    """Long graphs under tight budgets: almost every op co-locates on one of
    the graph's own tiles (the path a traced model step takes)."""
    rng = np.random.default_rng(seed)
    n_ops = 40
    steps = tuple(("u", UNARY[int(rng.integers(len(UNARY)))], i) for i in range(n_ops))
    rec = (1, steps, bool(seed % 2))
    tg, jg = build("torch", rec, "long"), build("jax", rec, "long")
    occ = _occupancy(seed, TileGrid(3, 3))
    for max_tiles in (1, 2, 3, None):
        try:
            jp = jplace.place_dynamic(jg, jplace.TileGrid(3, 3), occupied=occ,
                                      max_tiles=max_tiles)
        except jplace.PlacementError:
            with pytest.raises(PlacementError):
                tplace.place_dynamic(tg, TileGrid(3, 3), occupied=occ, max_tiles=max_tiles)
            continue
        tp = tplace.place_dynamic(tg, TileGrid(3, 3), occupied=occ, max_tiles=max_tiles)
        assert tp.assignment == jp.assignment


@pytest.mark.parametrize("bad", ["none", "large_on_small", "off_grid",
                                 "unknown_node", "missing_node"])
def test_check_assignment_matches_jax(bad):
    tg, jg = vmul_reduce_graph(N), jgraph.vmul_reduce_graph(N)
    tgrid, jgrid = TileGrid(3, 3), jplace.TileGrid(3, 3)
    tp = place(tg, tgrid, PlacementPolicy.DYNAMIC)
    jp = jplace.place(jg, jgrid, jplace.PlacementPolicy.DYNAMIC)
    ops = [n.node_id for n in tg.op_nodes()]           # VMUL, Reduce (LARGE)
    assignment = {"none": dict(tp.assignment),
                  "large_on_small": {ops[0]: (0, 1), ops[1]: (0, 2)},
                  "off_grid": {ops[0]: (9, 9), ops[1]: (0, 0)},
                  "unknown_node": {**tp.assignment, 99: (0, 1)},
                  "missing_node": {ops[1]: (0, 0)}}[bad]
    results = []
    for check, pl, g, grid, err in (
            (check_assignment, tp, tg, tgrid, PlacementError),
            (jplace.check_assignment, jp, jg, jgrid, jplace.PlacementError)):
        try:
            check(g, grid, dataclasses.replace(pl, assignment=assignment))
            results.append("ok")
        except err as exc:
            results.append(str(exc))
    assert results[0] == results[1]
    assert (results[0] == "ok") == (bad == "none")


# ---------------------------------------------------------------------------
# the fabric's relocation and reclaim ledger
# ---------------------------------------------------------------------------
def test_fabric_relocate_keeps_artifacts_and_ledger():
    ov = Overlay(3, 3)
    g = saxpy_graph(N)
    acc = ov.assemble(g)
    rid = acc.resident_id
    ov.fabric.record_download_cost(rid, 1.5)
    cost = ov.fabric.download_cost(rid)
    res = ov.fabric.get(rid)
    keys_before, gen_before = res.cache_keys, res.generation
    assert keys_before and cost > 0.0
    new_pl = place(g, ov.grid, ov.policy, occupied=set(res.tiles))
    moved = ov.fabric.relocate(rid, new_pl, compile_graph(g, new_pl))
    assert moved.cache_keys == keys_before        # kernel artifacts survive
    assert ov.fabric.download_cost(rid) == cost   # ledger intact
    assert moved.generation > gen_before          # dispatch records refresh
    assert moved.admit_generation == res.admit_generation
    assert ov.fabric.same_residency(rid, gen_before)
    assert not ov.fabric.is_current(rid, gen_before)


def test_fabric_relocate_onto_occupied_tiles_raises():
    ov = Overlay(2, 2, large_fraction=0.0)
    g1, g2 = saxpy_graph(32, alpha=1.0), saxpy_graph(32, alpha=2.0)
    g1.name, g2.name = "one", "two"
    acc1 = ov.assemble(g1)
    clashing = ov.fabric.get(ov.assemble(g2).resident_id).placement
    with pytest.raises(FabricError):
        ov.fabric.relocate(acc1.resident_id, clashing, compile_graph(g1, clashing))


@pytest.mark.parametrize("costs,want", [((None, None, None), "a"),
                                        ((5.0, 0.1, 1.0), "b"),
                                        ((0.2, 9.0, 9.0), "a")])
def test_cost_aware_reclaim_victim_matches_jax(costs, want):
    """age / re-download cost picks the victim; unmeasured residents are
    priced at the mean of the measured ones (all unmeasured: LRU)."""
    victims = []
    for pkg in ("jax", "torch"):
        ov = JOverlay(3, 3) if pkg == "jax" else Overlay(3, 3)
        for name, cost in zip("abc", costs):
            g = canned(pkg, "saxpy", name)
            rid = ov.assemble(g).resident_id
            ov.fabric._download_costs.pop(rid, None)
            if cost is not None:
                ov.fabric.record_download_cost(rid, cost)
        victims.append(ov.fabric.reclaim_victim(cost_aware=True).name)
        assert ov.fabric.lru().name == "a"
        assert ov.fabric.free() == [c for c in ov.grid.coords()
                                    if c not in ov.fabric.occupied()]
    assert victims[0] == victims[1] == want


# ---------------------------------------------------------------------------
# the reference's relocation tests, mirrored on the port (Graph level)
# ---------------------------------------------------------------------------
def test_public_relocate_rejects_invalid_placements():
    ov = Overlay(3, 3)
    g = vmul_reduce_graph(N)
    ov.assemble(g)
    (res,) = ov.fabric.residents.values()
    ops = g.op_nodes()
    for assignment in ({ops[0].node_id: (0, 1), ops[1].node_id: (0, 2)},
                       {ops[0].node_id: (9, 9), ops[1].node_id: (0, 0)}):
        with pytest.raises(PlacementError):
            ov.relocate(g, dataclasses.replace(res.placement, assignment=assignment))
    assert ov.stats.relocations == 0


def test_relocation_preserves_numerics_bit_identical():
    ov = Overlay(3, 3)
    g = vmul_reduce_graph(512)
    a, b = torch.linspace(0.0, 1.0, 512), torch.linspace(1.0, 2.0, 512)
    acc = ov.assemble(g)
    y0 = acc(a, b)
    old_tiles = set(ov.fabric.get(acc.resident_id).tiles)
    ins, ev = ov.cache.stats.insertions, ov.cache.stats.evictions
    moved = ov.relocate(g, place(g, ov.grid, ov.policy, occupied=old_tiles))
    assert moved.tiles and not (moved.tiles & old_tiles)
    assert moved.relocations == 1
    assert torch.equal(ov.assemble(g)(a, b), y0)
    assert (ov.cache.stats.insertions, ov.cache.stats.evictions) == (ins, ev)


def test_relocate_by_accelerator_name():
    ov = Overlay(3, 3)
    g = saxpy_graph(N)
    res = ov.fabric.get(ov.assemble(g).resident_id)
    new_pl = place(g, ov.grid, ov.policy, occupied=set(res.tiles))
    assert ov.relocate("saxpy", new_pl).relocations == 1
    with pytest.raises(FabricError):
        ov.relocate("no-such-accelerator", new_pl)


def test_route_program_table_stays_bounded_under_repeated_moves():
    ov = Overlay(3, 3)
    g = saxpy_graph(N)
    acc = ov.assemble(g)
    for _ in range(5):
        res = ov.fabric.get(acc.resident_id)
        ov.relocate(g, place(g, ov.grid, ov.policy, occupied=set(res.tiles)))
        acc = ov.assemble(g)
    assert ov.cache.route_programs() == 1
    assert ov.cache.route_stats.emitted == 6      # initial + 5 moves


def test_defragment_moves_without_kernel_evictions_or_insertions():
    ov = Overlay(2, 2, large_fraction=0.0)
    g1, g2 = saxpy_graph(32, alpha=1.0), saxpy_graph(32, alpha=2.0)
    g1.name, g2.name = "front", "back"
    ov.assemble(g1)
    x = torch.linspace(0.0, 1.0, 32)
    y0 = ov.assemble(g2)(x, x)
    ov.evict(g1)
    ins, ev = ov.cache.stats.insertions, ov.cache.stats.evictions
    assert ov.defragment() == 1
    assert (ov.cache.stats.insertions, ov.cache.stats.evictions) == (ins, ev)
    assert torch.equal(ov.assemble(g2)(x, x), y0)
    assert ov.cache.stats.insertions == ins
    (res,) = ov.fabric.residents.values()
    assert res.relocations == 1
    assert ov.describe()["fabric"]["residents"][res.rid]["relocations"] == 1


def test_defrag_failure_counts_and_warns(caplog):
    ov = Overlay(2, 2, large_fraction=0.5)
    ov.assemble(vmul_reduce_graph(N))              # Reduce is LARGE
    ov.assemble(saxpy_graph(N))
    ov.evict("saxpy")
    ov.grid = TileGrid(2, 2, large_fraction=0.0)   # the LARGE tiles go away
    ov.fabric.grid = ov.grid
    with caplog.at_level(logging.WARNING, logger="repro_torch.core.overlay"):
        assert ov.defragment() == 0
    assert ov.stats.defrag_failures == 1 and ov.stats.defrags == 0
    assert any("vmul_reduce" in rec.getMessage() for rec in caplog.records)
    assert ov.describe()["defrag_failures"] == 1


def test_tile_budget_repack_relocates_without_redownload():
    ov = Overlay(3, 3, large_fraction=0.0)
    g = saxpy_graph(N)
    acc = ov.assemble(g)
    assert len(set(acc.placement.assignment.values())) == 2
    x = torch.linspace(0.0, 1.0, N)
    y0 = acc(x, x)
    ins = ov.cache.stats.insertions
    acc2 = ov.assemble(saxpy_graph(N), tile_budget=1)
    assert len(set(acc2.placement.assignment.values())) == 1
    assert ov.stats.relocations == 1 and ov.cache.stats.insertions == ins
    assert torch.equal(acc2(x, x), y0)
    assert ov.fabric.get(acc2.resident_id).tile_budget == 1
    ov.assemble(saxpy_graph(N), tile_budget=1)
    assert ov.stats.relocations == 1


def test_reconfigure_relocate_keeps_residents_and_cache():
    ov = Overlay(3, 3)
    ov.assemble(vmul_reduce_graph(128))
    ov.assemble(saxpy_graph(128))
    cached, ins = len(ov.cache), ov.cache.stats.insertions
    ov.reconfigure(policy=PlacementPolicy.STATIC, relocate=True)
    assert ov.policy is PlacementPolicy.STATIC
    assert len(ov.fabric) == 2 and len(ov.cache) == cached
    acc = ov.assemble(vmul_reduce_graph(128))
    assert acc.placement.policy is PlacementPolicy.STATIC
    assert ov.cache.stats.insertions == ins
    a = torch.linspace(0.0, 1.0, 128)
    torch.testing.assert_close(acc(a, a), torch.sum(a * a), rtol=1e-6, atol=0)


def test_reconfigure_relocate_evicts_only_unplaceable_residents():
    ov = Overlay(2, 2, large_fraction=0.5)
    ov.assemble(vmul_reduce_graph(N))
    ov.assemble(saxpy_graph(N))
    ov.reconfigure(large_fraction=0.0, relocate=True)
    assert {r.name for r in ov.fabric.residents.values()} == {"saxpy"}


# ---------------------------------------------------------------------------
# the reference's jit-level relocation tests, mirrored on the port's jit
# ---------------------------------------------------------------------------
def test_jitted_fn_survives_defrag_without_redownload_sync():
    ov = Overlay(2, 2, large_fraction=0.0)
    filler = ov.jit(lambda x: x * 2.0 + 1.0, name="filler")
    moved = ov.jit(lambda x: x * 3.0 - 1.0, name="mover")
    x = torch.linspace(0.0, 1.0, 64)
    y_fill = filler(x)
    y0 = moved(x)
    ov.evict("filler")
    ins, downloads = ov.cache.stats.insertions, ov.stats.downloads
    assert ov.defragment() == 1
    y1 = moved(x)                                  # rebound, not re-downloaded
    assert torch.equal(y0, y1)
    assert ov.cache.stats.insertions == ins and ov.stats.downloads == downloads
    torch.testing.assert_close(y_fill, x * 2.0 + 1.0)


def test_jit_tile_budget_resize_relocates_in_place():
    ov = Overlay(3, 3, large_fraction=0.0)
    jitted = ov.jit(lambda x, y: x * 2.0 + y, name="resizable", tile_budget=2)
    x = torch.linspace(0.0, 1.0, 32)
    y0 = jitted(x, x)
    assert len(set(jitted.accelerator(x, x).placement.assignment.values())) == 2
    ins = ov.cache.stats.insertions
    jitted.tile_budget = 1                         # what ServeEngine.resize sets
    y1 = jitted(x, x)
    assert len(set(jitted.accelerator(x, x).placement.assignment.values())) == 1
    assert ov.stats.relocations == 1 and ov.cache.stats.insertions == ins
    assert torch.equal(y0, y1)


def test_relocation_rebinds_live_entries_inline():
    """The synchronous overlay rebinds a moved resident's jit entries at the
    move, so the next call takes the fast path on the new routes."""
    ov = Overlay(2, 2, large_fraction=0.0)
    filler = ov.jit(lambda x: x + 1.0, name="filler")
    mover = ov.jit(lambda x: x * 5.0 + 2.0, name="mover")
    x = torch.ones(32)
    filler(x)
    y0 = mover(x)
    ov.evict("filler")
    assert ov.defragment() == 1
    (entry,) = mover._entries.values()
    assert entry.record is not None and ov.resident_current(entry.acc)
    assert entry.record.generation == ov.fabric.get(entry.acc.resident_id).generation
    assemblies = ov.stats.assemblies
    assert torch.equal(mover(x), y0)
    assert ov.stats.assemblies == assemblies       # no slow path


def test_sync_prefetch_and_timings():
    ov = Overlay(3, 3)
    jitted = ov.jit(lambda a, b: torch.sum(a * b), name="dot")
    spec = tgraph.TensorSpec((N,), torch.float32, torch.device("cpu"))
    assert jitted.prefetch(spec, spec) is None
    assert ov.stats.prefetches == 1 and ov.stats.downloads == 1
    jitted.prefetch(spec, spec)                    # resident: a no-op
    assert ov.stats.prefetches == 1
    a = torch.ones(N)
    assert float(jitted(a, a)) == N
    assert ov.stats.prefetch_hits == 1 and ov.stats.downloads == 1
    t = jitted.timings(a, a)
    assert t["trace_seconds"] > 0.0 and t["assemble_seconds"] > 0.0


@pytest.mark.parametrize("option", ["auto_defragment", "cost_aware_reclaim",
                                    "cost_model_placement", "autotune_thresholds"])
def test_planner_options_keep_numerics(option):
    """Each option changes where and what gets reclaimed, never what a call
    returns."""
    ov = Overlay(2, 2, **{option: True})
    fns = [ov.jit(lambda x, k=k: torch.sqrt(torch.abs(x) + k) * x, name=f"f{k}")
           for k in range(4)]
    x = torch.linspace(-1.0, 1.0, 32)
    for _ in range(2):
        for k, f in enumerate(fns):
            assert torch.equal(f(x), torch.sqrt(torch.abs(x) + k) * x)
    assert ov.stats.reclaims > 0
    assert getattr(ov, option) is True


# ---------------------------------------------------------------------------
# the serving engine's fabric controls (smoke size)
# ---------------------------------------------------------------------------
def _smoke_engine_setup():
    cfg = smoke_config("phi3-mini-3.8b").scaled(d_model=128, head_dim=32,
                                                dtype="float32")
    params = pytree.tree_map(lambda t: t.float(),
                             tparams.init(cfg, torch.Generator().manual_seed(0), "cpu"))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=(5,)).tolist() for _ in range(3)]
    return cfg, params, prompts


def _serve(engine, prompts, start=0):
    for i, p in enumerate(prompts):
        engine.submit(Request(rid=start + i, prompt=p, max_new_tokens=3))
    return [r.out for r in sorted(engine.run_until_drained(), key=lambda r: r.rid)]


def test_engine_warmup_compact_resize_keep_streams_and_kernels():
    cfg, params, prompts = _smoke_engine_setup()
    want = _serve(ServeEngine(params, cfg, batch=2, max_len=16, device="cpu"), prompts)
    ov = Overlay(3, 3)
    cotenant = ov.jit(lambda a, b: torch.sum(a * b), name="cotenant")
    a = torch.ones(1 << 12)
    cotenant(a, a)
    engine = ServeEngine(params, cfg, batch=2, max_len=16, overlay=ov,
                         tile_budget=3, device="cpu")
    assert engine.tile_budget == 3
    engine.warmup(prompt_lens=(5,))
    assert (ov.stats.traces, ov.stats.downloads) == (3, 3)   # cotenant + 2
    assert ov.stats.prefetches == 2
    assert _serve(engine, prompts) == want
    assert (ov.stats.traces, ov.stats.downloads) == (3, 3)   # warm: no new work
    assert ov.stats.prefetch_hits == 2
    ov.evict("cotenant")
    ins, downloads, moves = ov.cache.stats.insertions, ov.stats.downloads, ov.stats.relocations
    assert engine.compact() >= 1
    assert ov.stats.relocations > moves
    assert _serve(engine, prompts, start=10) == want
    engine.resize(1)
    moves = ov.stats.relocations
    assert _serve(engine, prompts, start=20) == want
    assert ov.stats.relocations > moves
    for res in ov.fabric.residents.values():
        assert res.tile_budget == 1 and res.downloads == 1
    assert (ov.cache.stats.insertions, ov.stats.downloads) == (ins, downloads)
    with pytest.raises(ValueError):
        engine.resize(0)
    plain = ServeEngine(params, cfg, batch=2, max_len=16, device="cpu")
    assert plain.compact() == 0 and plain.warmup((5,)) is None
    with pytest.raises(ValueError):
        plain.resize(2)
