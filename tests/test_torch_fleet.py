"""The port's fleet overlay (``repro_torch.core.fleet``): placement,
replication, routing, cross-fabric reclaim, member health, the shared store,
the fleet checkers and fleet-backed serving.

The reference's tests of the same behaviour (``tests/test_fleet.py``, the
fleet cases of ``test_faults.py``, ``test_store.py``,
``test_sanitizer_stress.py``, ``test_serving_loop.py`` and
``test_analysis_check.py``) go through the JAX ``FleetOverlay.jit``, whose
tracer fails on the installed jax; here they run on the port's own tracer.
The fleet's decisions are held against the JAX ``FleetOverlay`` on the graph
path (``assemble`` of hand-built graphs), which needs no tracer: the same
seeded sequence gives the same homes, placements, scores and stats on both,
and the health machine the same transitions on the same error counts.
"""

import dataclasses
import json
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from repro.core import fleet as jfleet
from repro.core import graph as jgraph
from repro_torch.analysis import check
from repro_torch.configs import smoke_config
from repro_torch.core import (BitstreamStore, FaultPlan, FleetOverlay, Overlay,
                              PlacementError)
from repro_torch.core import graph as tgraph
from repro_torch.core.fleet import FleetJitAssembled, FleetStats
from repro_torch.models import params as tparams
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.loop import EventLoopEngine

X = torch.arange(8, dtype=torch.float32)
Y = torch.ones(8, dtype=torch.float32)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _mul(a, b):
    return a * b + 1.0


def _fleet(n=2, **kw):
    kw.setdefault("rows", 3)
    kw.setdefault("cols", 3)
    kw.setdefault("window", 8)
    kw.setdefault("replicate_after", 4)
    kw.setdefault("drain_below", 1)
    return FleetOverlay(n, **kw)


# ---------------------------------------------------------------------------
# the graph path against the JAX FleetOverlay
# ---------------------------------------------------------------------------
N = 64
GRAPHS = ("vmul", "saxpy", "branchy")
COSTS = {"vmul": 2.0, "saxpy": 0.5, "branchy": 1.0}


def _graphs(mod) -> dict:
    out = {"vmul": mod.vmul_reduce_graph(N), "saxpy": mod.saxpy_graph(N, 3.0),
           "branchy": mod.branchy_graph(N)}
    for name, g in out.items():
        g.name = name
    return out


def _script(seed: int, steps: int = 14) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        r = rng.random()
        if r < 0.7:
            out.append(("admit", GRAPHS[rng.integers(3)], int(rng.integers(1, 4))))
        elif r < 0.8:
            out.append(("evict", GRAPHS[rng.integers(3)]))
        elif r < 0.9:
            out.append(("defrag",))
        else:
            out.append(("kill", int(rng.integers(3))))
    return out


def _pin(fleet):
    """Every resident's download cost at the script's price: the packages
    measure different build times, and the score reads them."""
    for m in fleet.members:
        for res in m.fabric.residents.values():
            m.fabric._download_costs[res.rid] = COSTS[res.name]
            res.download_cost = COSTS[res.name]


def _apply(fleet, gs, action):
    kind, *args = action
    try:
        if kind == "admit":
            fleet.assemble(gs[args[0]], tile_budget=args[1])
        elif kind == "evict":
            fleet.evict(args[0])
        elif kind == "defrag":
            fleet.defragment()
        elif kind == "kill":
            fleet.kill_member(args[0])
    except PlacementError:
        return "PlacementError"
    except Exception as exc:                        # the JAX PlacementError
        if type(exc).__name__ != "PlacementError":
            raise
        return "PlacementError"
    finally:
        _pin(fleet)
    return None


def _snapshot(fleet, gs):
    rids = {name: fleet.members[0]._resident_key(g, g.input_avals(), None)
            if hasattr(g, "input_avals") else
            fleet.members[0]._resident_key(
                g, tuple(g.toposorted()[i].aval for i in g.input_ids), None)
            for name, g in gs.items()}
    homes = {name: fleet._graph_homes.get(rid) for name, rid in rids.items()}
    tiles = [{r.name: sorted(r.tiles) for r in m.fabric.residents.values()}
             for m in fleet.members]
    return {"homes": homes, "tiles": tiles,
            "scores": [fleet._member_score(i) for i in range(len(fleet.members))],
            "stats": dataclasses.asdict(fleet.stats),
            "health": [h.state for h in fleet._health]}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_graph_path_decisions_match_the_jax_fleet(seed):
    jf = jfleet.FleetOverlay(3, rows=3, cols=3)
    tf = FleetOverlay(3, rows=3, cols=3)
    jgs, tgs = _graphs(jgraph), _graphs(tgraph)
    try:
        for action in _script(seed):
            assert _apply(tf, tgs, action) == _apply(jf, jgs, action), action
            got, want = _snapshot(tf, tgs), _snapshot(jf, jgs)
            assert got["homes"] == want["homes"], action
            assert got["tiles"] == want["tiles"], action
            assert got["stats"] == want["stats"], action
            assert got["health"] == want["health"], action
            assert got["scores"] == pytest.approx(want["scores"], abs=1e-12), action
    finally:
        jf.close()
        tf.close()


@pytest.mark.parametrize("seed", [0, 5, 9])
def test_health_transitions_match_the_jax_fleet(seed):
    """The same member error counts, window after window, step both health
    machines the same way (quarantine, probation, readmission)."""
    kw = dict(rows=2, cols=2, quarantine_errors=2, quarantine_windows=2)
    jf, tf = jfleet.FleetOverlay(3, **kw), FleetOverlay(3, **kw)
    rng = np.random.default_rng(seed)
    try:
        for _ in range(24):
            errs = rng.choice([0, 0, 0, 1, 2, 4], size=3)
            fails = rng.integers(0, 2, size=3)
            for fl in (jf, tf):
                for m, e, f in zip(fl.members, errs, fails):
                    m.stats.dispatch_failures += int(e)
                    m.stats.download_failures += int(f)
                with fl._lock:
                    fl._update_health()
            assert tf.health() == jf.health()
            assert dataclasses.asdict(tf.stats) == dataclasses.asdict(jf.stats)
            assert [tf._member_score(i) for i in range(3)] == pytest.approx(
                [jf._member_score(i) for i in range(3)], abs=1e-12)
    finally:
        jf.close()
        tf.close()


def test_fleet_stats_fields_match_the_reference():
    assert [f.name for f in dataclasses.fields(FleetStats)] == \
        [f.name for f in dataclasses.fields(jfleet.FleetStats)]


# ---------------------------------------------------------------------------
# placement (tests/test_fleet.py)
# ---------------------------------------------------------------------------
def test_distinct_accelerators_spread_across_members():
    fleet = _fleet(2)
    fns = [fleet.jit(lambda x, s=float(i): x * s + s, name=f"acc{i}")
           for i in range(4)]
    for f in fns:
        f(X)
    hosts = {i for i in range(2) if len(fleet.members[i].fabric) > 0}
    assert hosts == {0, 1}           # the free-tile score spreads the working set
    assert fleet.stats.placements == 4
    fleet.close()


def test_single_member_fleet_degenerates_to_one_overlay():
    fleet = _fleet(1)
    f = fleet.jit(lambda x: x + 1.0, name="inc")
    assert torch.equal(f(X), X + 1.0)
    assert fleet.describe()["fleet"]["routed_per_member"] == [1]
    fleet.close()


def test_fleet_validates_watermarks():
    with pytest.raises(ValueError):
        FleetOverlay(2, replicate_after=4, drain_below=4)   # no hysteresis
    with pytest.raises(ValueError):
        FleetOverlay(0)
    with pytest.raises(ValueError):
        FleetOverlay([Overlay(2, 2)], async_downloads=True)  # kwargs clash


# ---------------------------------------------------------------------------
# replication + routing
# ---------------------------------------------------------------------------
def test_hot_accelerator_replicates_and_routing_splits_load():
    fleet = _fleet(2)
    f = fleet.jit(lambda x: x * 2.0 + 1.0, name="hot")
    for _ in range(40):
        out = f(X)
    assert torch.equal(out, X * 2.0 + 1.0)
    d = fleet.describe()["fleet"]
    assert d["replications"] >= 1
    assert d["replicas"] >= 1                      # live right now
    assert all(c > 0 for c in d["routed_per_member"])   # least-loaded split
    (rec,) = d["records"].values()
    assert [c["state"] for c in rec["copies"]].count("live") == 2
    fleet.close()


def test_replica_tears_down_when_traffic_subsides():
    fleet = _fleet(2)
    hot = fleet.jit(lambda x: x * 2.0, name="hot")
    for _ in range(16):
        hot(X)                                 # replicate
    assert fleet.describe()["fleet"]["replicas"] == 1
    cold = fleet.jit(lambda x: x * 3.0, name="cold")
    for _ in range(16):
        cold(X)                                # hot's window goes quiet
    d = fleet.describe()["fleet"]
    assert d["replica_teardowns"] >= 1
    assert d["replicas"] == 1                  # cold replicated, hot drained
    fleet.close()


def test_max_replicas_caps_copies():
    fleet = _fleet(3, max_replicas=2)
    f = fleet.jit(lambda x: x + 2.0, name="hot")
    for _ in range(64):
        f(X)
    (rec,) = fleet.describe()["fleet"]["records"].values()
    assert len(rec["copies"]) == 2
    fleet.close()


def test_async_replication_rides_low_lane_and_serves_after_drain():
    fleet = _fleet(2, async_downloads=True)
    f = fleet.jit(lambda x: x * 2.0 + 1.0, name="hot")
    for _ in range(16):
        f(X)
    assert fleet.drain(30.0)                   # the primary download lands
    for _ in range(8):
        f(X)                                   # the next window asks for a replica
    assert fleet.drain(30.0)                   # the replica download lands
    for _ in range(8):
        out = f(X)                             # routed to the fresh copy too
    assert torch.equal(out, X * 2.0 + 1.0)
    d = fleet.describe()["fleet"]
    assert d["replications"] >= 1
    assert d["routed_per_member"][1] > 0 and d["routed_per_member"][0] > 0
    assert sum(m.scheduler.stats.low_jobs for m in fleet.members) >= 1
    fleet.close()


# ---------------------------------------------------------------------------
# cross-fabric reclaim
# ---------------------------------------------------------------------------
def test_reclaim_takes_replica_before_sole_copy_and_routing_fails_over():
    """Under placement pressure a replicated resident loses its replica
    before ANY sole-copy resident is evicted, and routing fails over to the
    surviving copy with no dropped dispatch."""
    fleet = _fleet(2, rows=2, cols=2, window=4, replicate_after=2, drain_below=1)
    budget = 2
    hot = fleet.jit(lambda x, y: x * y + y, name="hot", tile_budget=budget)
    for _ in range(12):
        hot(X, Y)                              # replicated onto both members
    d = fleet.describe()["fleet"]
    assert [c["state"] for c in d["records"]["hot#0"]["copies"]] == ["live", "live"]
    # freeze the replication controller: only member-side pressure reclaim
    # can remove a copy below
    fleet.window = 1_000_000
    soles = [fleet.jit(lambda x, s=float(i): x + s, name=f"sole{i}", tile_budget=budget)
             for i in range(4)]
    for s in soles:
        s(X)
    assert all(not m.fabric.free() for m in fleet.members)
    sole_rids = {i: {rid for rid, r in fleet.members[i].fabric.residents.items()
                     if r.name.startswith("sole")} for i in range(2)}
    newcomer = fleet.jit(lambda x: x * 4.0, name="newcomer", tile_budget=budget)
    assert torch.equal(newcomer(X), X * 4.0)
    d = fleet.describe()["fleet"]
    states = [c["state"] for c in d["records"]["hot#0"]["copies"]]
    assert states.count("live") == 1           # exactly one hot copy lost
    for i in range(2):                         # every sole copy survived
        assert sole_rids[i] <= set(fleet.members[i].fabric.residents)
    reclaims_before = sum(m.stats.reclaims for m in fleet.members)
    assert reclaims_before >= 1                # the replica WAS reclaimed
    for _ in range(6):
        out = hot(X, Y)
    assert torch.equal(out, X * Y + Y)
    assert sum(m.stats.reclaims for m in fleet.members) == reclaims_before
    fleet.close()


def test_reclaim_prefer_narrows_the_victim_pool_on_both_planners():
    """``Fabric.reclaim_victim(prefer=)`` and the cost-model planner's
    ``_select_victim`` take a preferred resident over a colder one."""
    for planner in (False, True):
        ov = Overlay(2, 2, cost_model_placement=planner)
        fs = [ov.jit(lambda x, s=float(i): x + s, name=f"r{i}", tile_budget=1)
              for i in range(3)]
        for f in fs:
            f(X)
        hot = [r for r in ov.fabric.residents.values() if r.name == "r2"][0]
        ov.reclaim_prefer = lambda r: r.name == "r2"
        pick = ov._select_victim() if planner else ov.fabric.reclaim_victim(
            prefer=ov.reclaim_prefer)
        assert pick is hot
        assert ov.fabric.reclaim_victim().name == "r0"        # plain LRU
        ov.close()


# ---------------------------------------------------------------------------
# fleet-wide management surface
# ---------------------------------------------------------------------------
def test_fleet_evict_fans_out_and_clears_records():
    fleet = _fleet(2)
    f = fleet.jit(lambda x: x * 5.0, name="victim")
    for _ in range(16):
        f(X)                                   # resident on both members
    assert fleet.evict("victim") >= 1
    assert all("victim" not in {r.name for r in m.fabric.residents.values()}
               for m in fleet.members)
    assert fleet.describe()["fleet"]["records"] == {}
    assert torch.equal(f(X), X * 5.0)          # placed afresh
    fleet.close()


def test_fleet_reconfigure_flushes_members_and_keeps_serving():
    fleet = _fleet(2)
    f = fleet.jit(lambda x: x - 1.0, name="dec")
    f(X)
    d = fleet.reconfigure()
    assert d["fleet"]["size"] == 2
    assert all(len(m.fabric) == 0 for m in fleet.members)
    assert torch.equal(f(X), X - 1.0)
    fleet.close()


def test_describe_shape_is_stable_and_json_serializable():
    fleet = _fleet(2)
    f = fleet.jit(lambda x: x * 2.0, name="acc")
    for _ in range(12):
        f(X)
    d = fleet.describe()
    json.dumps(d)                              # strictly JSON-serializable
    assert len(d["members"]) == 2
    for m in d["members"]:
        assert {"fabric", "downloads", "grid"} <= set(m)
    fl = d["fleet"]
    assert {"size", "window", "replicate_after", "drain_below", "max_replicas",
            "replicas", "routed_per_member", "scores", "records", "placements",
            "replications", "replica_teardowns", "replicas_lost", "failovers",
            "rebalances", "routed"} <= set(fl)
    assert fl["size"] == 2 and len(fl["routed_per_member"]) == 2
    assert sum(fl["routed_per_member"]) == fl["routed"] == 12
    for rec in fl["records"].values():
        assert {"name", "hits", "window_hits", "copies"} <= set(rec)
        for c in rec["copies"]:
            assert {"member", "rid", "primary", "state", "routed", "inflight"} <= set(c)
            assert c["state"] in ("live", "pending", "dead")
    assert check.check_fleet_describe(fleet) == []
    fleet.close()


# ---------------------------------------------------------------------------
# fleet-backed serving
# ---------------------------------------------------------------------------
def _prompts(vocab, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(n,)).tolist() for n in (4, 3, 3)]


def _serve(engine, prompts, max_new=3):
    for rid, p in enumerate(prompts):
        engine.submit(Request(rid=rid, prompt=list(p), max_new_tokens=max_new))
    return {r.rid: r.out for r in engine.run_until_drained()}


def test_serve_engine_on_fleet_matches_single_overlay_tokens():
    cfg = smoke_config("phi3-mini-3.8b")
    params = tparams.init(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = _prompts(cfg.vocab_size)
    single = _serve(ServeEngine(params, cfg, batch=2, max_len=32, overlay=Overlay(3, 3),
                                device="cpu"), prompts)
    plain = _serve(ServeEngine(params, cfg, batch=2, max_len=32, device="cpu"), prompts)
    fleet = _fleet(2)
    got = _serve(ServeEngine(params, cfg, batch=2, max_len=32, overlay=fleet,
                             device="cpu"), prompts)
    assert got == single == plain               # identical token streams
    assert fleet.describe()["fleet"]["placements"] >= 2   # prefill + decode
    fleet.close()


def test_event_loop_on_an_async_fleet_matches_plain():
    cfg = smoke_config("phi3-mini-3.8b")
    params = tparams.init(cfg, torch.Generator().manual_seed(1), "cpu")
    prompts = _prompts(cfg.vocab_size, seed=4)

    def run(overlay):
        return _serve(EventLoopEngine(params, cfg, batch=2, max_len=32, chunk=4,
                                      overlay=overlay, device="cpu"), prompts, max_new=6)

    want = run(None)
    fleet = _fleet(2, window=4, replicate_after=2, async_downloads=True)
    got = run(fleet)
    assert fleet.drain(60.0)
    assert got == want
    d = fleet.describe()["fleet"]
    assert d["placements"] >= 2 and d["replications"] >= 1
    assert sum(m.scheduler.stats.low_jobs for m in fleet.members) >= 1
    fleet.close()


# ---------------------------------------------------------------------------
# member health: quarantine, readmission, death, evacuation (test_faults.py)
# ---------------------------------------------------------------------------
def test_quarantine_then_readmission_after_clean_windows():
    plan = FaultPlan(13, download_failure_rate=1.0)
    m0 = Overlay(3, 3, faults=plan)
    m1 = Overlay(3, 3)
    fleet = FleetOverlay([m0, m1], window=4, replicate_after=3, drain_below=1,
                         quarantine_errors=1, quarantine_windows=1)
    f = fleet.jit(_mul, name="sick")       # the first placement lands on m0
    with pytest.warns(RuntimeWarning):
        for _ in range(8):
            f(X, Y)
    assert fleet._health[0].state in ("quarantined", "probation")
    assert fleet.stats.quarantines >= 1
    m0.faults = None                       # outage over: probes succeed
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for _ in range(40):
            assert torch.equal(f(X, Y), _mul(X, Y))
    assert fleet._health[0].state == "healthy"
    assert fleet.stats.readmissions >= 1
    assert not check.check_fleet(fleet)
    led = fleet.failure_ledger()
    assert led["quarantines"] >= 1 and led["quarantined_members"] == []
    fleet.close()


def test_kill_member_evacuates_sole_copies_and_keeps_serving():
    fleet = FleetOverlay(2, rows=3, cols=3, window=64, replicate_after=10 ** 6)
    f = fleet.jit(_mul, name="refugee")
    want = f(X, Y)                         # the sole copy lands on member 0
    assert len(fleet.members[0].fabric) == 1
    fleet.kill_member(0)
    assert fleet.stats.member_deaths == 1
    assert fleet.stats.evacuations == 1
    assert len(fleet.members[0].fabric) == 0       # flushed
    assert len(fleet.members[1].fabric) == 1       # re-homed
    for _ in range(3):                     # nothing dropped across the death
        assert torch.equal(f(X, Y), want)
    assert fleet._health[0].state == "dead"
    assert fleet.failure_ledger()["dead_members"] == [0]
    assert not check.check_fleet(fleet)
    fleet.kill_member(0)                   # idempotent
    assert fleet.stats.member_deaths == 1
    with pytest.raises(ValueError):
        fleet.kill_member(9)
    fleet.close()


def test_fault_plan_member_deaths_kill_via_dispatch_count():
    plan = FaultPlan(7, member_deaths={0: 3})
    fleet = FleetOverlay(2, rows=3, cols=3, window=64, replicate_after=10 ** 6,
                         faults=plan)
    assert fleet.members[0].faults is plan  # the plan reaches the members
    f = fleet.jit(_mul, name="doomed_home")
    want = f(X, Y)
    for _ in range(6):
        assert torch.equal(f(X, Y), want)
    assert fleet.stats.member_deaths == 1
    assert fleet.stats.evacuations == 1
    assert fleet._health[0].state == "dead"
    fleet.close()


def test_fleet_retries_failed_dispatch_on_another_replica():
    m0, m1 = Overlay(3, 3), Overlay(3, 3)
    fleet = FleetOverlay([m0, m1], window=4, replicate_after=2, drain_below=1,
                         quarantine_errors=10 ** 6)
    f = fleet.jit(_mul, name="failover")
    want = _mul(X, Y)
    for _ in range(8):                     # warm: a replica made on m1
        f(X, Y)
    assert fleet.stats.replications >= 1
    m0.faults = FaultPlan(17, dispatch_failure_rate=1.0)
    for _ in range(8):                     # m0 dispatches fail: failover
        assert torch.equal(f(X, Y), want)
    assert fleet.stats.dispatch_retries >= 1
    assert fleet.failure_ledger()["fleet_dispatch_retries"] >= 1
    assert not check.check_fleet(fleet)
    fleet.close()


def test_dead_member_never_takes_new_placements():
    fleet = FleetOverlay(2, rows=3, cols=3, window=64)
    fleet.kill_member(0)
    fns = [fleet.jit(lambda x, s=float(i): x * s, name=f"p{i}") for i in range(3)]
    for f in fns:
        f(X)
    assert len(fleet.members[0].fabric) == 0
    assert len(fleet.members[1].fabric) == 3
    fleet.close()


def test_fleet_drain_shares_one_deadline_across_members():
    fleet = FleetOverlay(3, rows=3, cols=3)
    granted = []

    def slow_drain(timeout=None):
        granted.append(timeout)
        time.sleep(0.15)
        return False

    for m in fleet.members:
        m.drain = slow_drain
    t0 = time.monotonic()
    assert fleet.drain(timeout=0.5) is False
    assert time.monotonic() - t0 < 1.0
    assert granted[0] <= 0.5
    assert granted[1] < granted[0] and granted[2] < granted[1]
    fleet.close()


def test_check_fleet_flags_quarantined_primary_with_live_standby():
    fleet = FleetOverlay(2, rows=3, cols=3, window=4, replicate_after=2, drain_below=1)
    f = fleet.jit(_mul, name="hot")
    for _ in range(16):                    # hot enough to replicate
        f(X, Y)
    assert fleet.stats.replications >= 1
    assert not check.check_fleet(fleet)
    rec = next(iter(f._records.values()))
    fleet._health[rec.replicas[0].member_index].state = "quarantined"
    assert "fleet/quarantined-primary" in [v.rule for v in check.check_fleet(fleet)]
    with fleet._lock:                      # ...and demotion repairs it
        fleet._demote_member(rec.replicas[0].member_index)
    assert not check.check_fleet(fleet)
    fleet._health.append(object())
    assert any(v.rule == "fleet/health-size" for v in check.check_fleet(fleet))
    fleet._health.pop()
    fleet.close()


# ---------------------------------------------------------------------------
# the shared store (test_store.py)
# ---------------------------------------------------------------------------
def test_fleet_shares_one_store(tmp_path):
    d = str(tmp_path / "store")
    fleet = FleetOverlay(2, rows=3, cols=3, store_path=d)
    assert fleet.store is not None
    assert all(m.store is fleet.store for m in fleet.members)
    a = torch.ones(32)
    out1 = fleet.jit(_mul, name="fleetacc")(a, a)
    fleet.drain()
    fleet.close()
    assert len(BitstreamStore(d).keys()) >= 1
    fleet2 = FleetOverlay(2, rows=3, cols=3, store_path=d)
    out2 = fleet2.jit(_mul, name="fleetacc")(a, a)
    assert torch.equal(out1, out2)
    assert sum(m.cache.stats.store_hits for m in fleet2.members) >= 1
    fleet2.close()


def test_fleet_store_kwargs_guardrails(tmp_path):
    with pytest.raises(ValueError):
        FleetOverlay(2, store=BitstreamStore(str(tmp_path / "a")),
                     store_path=str(tmp_path / "b"))
    with pytest.raises(ValueError):
        FleetOverlay([Overlay(2, 2), Overlay(2, 2)], store_path=str(tmp_path / "c"))


def test_concurrent_members_one_directory(tmp_path):
    """Two members persisting different accelerators into one directory at
    once: every save lands, and the index stays consistent."""
    d = str(tmp_path / "store")
    fleet = FleetOverlay(2, rows=3, cols=3, store_path=d)
    a = torch.ones(32)
    fns = [fleet.members[i].jit(lambda x, y, s=float(i + 2): x * y * s, name=f"conc{i}")
           for i in range(2)]
    for f in fns:
        f.lower(a, a)                      # make_fx traces on the main thread
    outs = {}
    threads = [threading.Thread(target=lambda i=i: outs.__setitem__(i, fns[i](a, a)))
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    fleet.drain()
    fleet.close()
    assert len(BitstreamStore(d).keys()) == 2
    assert torch.equal(outs[0], a * 2.0) and torch.equal(outs[1], a * 3.0)


# ---------------------------------------------------------------------------
# the sanitizer, latency feedback and the checkers
# ---------------------------------------------------------------------------
def test_fleet_inherits_sanitize_from_members(monkeypatch):
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    fleet = FleetOverlay(2, rows=3, cols=3, window=3, replicate_after=2,
                         drain_below=1, sanitize=True)
    assert fleet.sanitize is True
    assert all(m.sanitize for m in fleet.members)
    calls = []
    real = check.check_fleet
    monkeypatch.setattr(check, "check_fleet",
                        lambda fl, **kw: calls.append(kw) or real(fl, **kw))
    g = fleet.jit(lambda a: torch.sum(a) * 2.0, name="fleet_san")
    x = torch.ones(4, 4)
    for _ in range(7):
        g(x)                    # crosses >= 2 rebalance edges (window=3)
    assert fleet.stats.rebalances >= 2
    assert calls and all(kw == {"pruned": True} for kw in calls)
    fleet.close()
    quiet = FleetOverlay(2, rows=3, cols=3)
    assert quiet.sanitize is False
    quiet.close()


def test_fleet_describe_and_latency_aware_score():
    fleet = FleetOverlay(2, rows=3, cols=3)
    cold = [fleet._member_score(i) for i in range(2)]
    assert cold[0] == cold[1]    # no dispatch recorded: the latency term is 0
    for _ in range(8):
        fleet.members[0].dispatch_hist.record(100_000)
        fleet.members[1].dispatch_hist.record(10)
    assert fleet._member_score(0) < fleet._member_score(1)
    d = fleet.describe()
    assert len(d["fleet"]["dispatch_p50_us"]) == 2
    assert d["fleet"]["dispatch_p50_us"][0] > d["fleet"]["dispatch_p50_us"][1]
    assert len(d["fleet"]["dispatch_p99_us"]) == 2
    fleet.close()


def test_checkers_green_on_live_fleet():
    fleet = FleetOverlay(2, rows=3, cols=3)
    g = fleet.jit(lambda a: torch.sum(a) * 2.0, name="chk_fleet")
    x = torch.ones(4, 4)
    for _ in range(4):
        g(x)
    with fleet._lock:
        assert check.check_fleet(fleet) == []
        assert check.check_fleet(fleet, pruned=True) == []
    fleet.close()


def _rules(violations):
    return {v.rule for v in violations}


def test_fleet_rules_fire_on_corruption():
    fleet = FleetOverlay(2, rows=3, cols=3)
    g = fleet.jit(lambda a: torch.sum(a) * 3.0, name="chk_fleet_bad")
    g(torch.ones(4, 4))
    rec = next(iter(g._records.values()))
    rep = rec.replicas[0]
    keep = rec.replicas
    rec.replicas = keep + (dataclasses.replace(rep),)
    assert _rules(check.check_fleet(fleet)) == {"fleet/replica-dup"}
    rec.replicas = keep + (dataclasses.replace(rep),) * 2     # 3 > max_replicas
    assert "fleet/replica-count" in _rules(check.check_fleet(fleet))
    rec.replicas = (dataclasses.replace(rep, member_index=7),)
    assert "fleet/replica-index" in _rules(check.check_fleet(fleet))
    rec.replicas = ()
    assert "fleet/replica-empty" in _rules(check.check_fleet(fleet))
    rec.replicas = keep
    fleet._graph_homes["ghost"] = 9
    assert "fleet/home-index" in _rules(check.check_fleet(fleet))
    del fleet._graph_homes["ghost"]
    fleet._health[0].state = "confused"
    assert "fleet/health-size" in _rules(check.check_fleet(fleet))
    fleet._health[0].state = "healthy"
    assert check.check_fleet(fleet) == []
    fleet.close()


def test_fleet_describe_schema_is_stable_and_drift_is_caught():
    fleet = FleetOverlay(2, rows=3, cols=3)
    g = fleet.jit(lambda a: torch.sum(a) * 5.0, name="chk_desc")
    for _ in range(3):
        g(torch.ones(4, 4))
    assert check.check_fleet_describe(fleet) == []
    real = fleet.describe

    def drifted():
        d = real()
        d["fleet"].pop("scores")
        d["fleet"]["scorez"] = []
        next(iter(d["fleet"]["records"].values()))["copies"][0]["extra"] = 1
        return d

    fleet.describe = drifted
    rules = _rules(check.check_fleet_describe(fleet))
    assert {"describe/fleet-schema", "describe/fleet-copy-schema"} <= rules
    fleet.close()


def test_concurrent_dispatch_stays_correct_under_rebalances():
    """Eight threads dispatch through one fleet wrapper while rebalances
    replicate and tear copies down (the routing counters are lock-free
    estimates): every answer is right and the records stay consistent."""
    import sys

    fleet = _fleet(2, window=4, replicate_after=3, drain_below=1)
    f = fleet.jit(_mul, name="stress")
    for _ in range(12):                    # both members traced on this thread
        f(X, Y)
    assert len(f._member_wrappers) == 2
    want = _mul(X, Y)
    bad, errors = [], []

    def worker():
        try:
            for _ in range(30):
                if not torch.equal(f(X, Y), want):
                    bad.append(1)
        except Exception as exc:           # noqa: BLE001 — reported below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors and not bad
    assert fleet.stats.rebalances >= 10
    with fleet._lock:
        assert check.check_fleet(fleet, pruned=True) == []
    fleet.close()


def test_fleet_wrapper_is_the_fleet_surface():
    fleet = _fleet(2)
    f = fleet.jit(_mul, name="surface", tile_budget=2)
    assert isinstance(f, FleetJitAssembled)
    f(X, Y)
    f.tile_budget = 1                      # ServeEngine.resize's path
    assert all(w.tile_budget == 1 for w in f._member_wrappers.values())
    assert torch.equal(f(X, Y), _mul(X, Y))
    g = fleet.aot(_mul, X, Y, name="aot")
    assert fleet.stats.placements == 2
    assert torch.equal(g(X, Y), _mul(X, Y))
    with pytest.raises(ValueError):
        FleetOverlay(1).prefetch(g, X, Y)
    fleet.close()
