"""The port's verifier (``repro_torch.analysis``): the lock lint over
``src/repro_torch``, the invariant checkers on live and hand-corrupted
overlays, the sanitizer at the mutation edges, and the report.

Mirrors ``tests/test_locklint.py``, ``tests/test_analysis_check.py`` and
``tests/test_sanitizer_stress.py`` without using them as oracles (the
latter two drive the JAX ``Overlay.jit``, whose tracer fails on the
installed jax): the port is held to hand-corrupted states, and to the
reference's stdlib-only lint and frozen ``describe()`` key sets, which
import no jax.
"""

import dataclasses
import os
import textwrap
import threading

import pytest
import torch

from repro_torch.analysis import check, locklint
from repro_torch.analysis.check import InvariantError
from repro_torch.core import Overlay, PlacementError, saxpy_graph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src", "repro_torch")
FIXTURE = os.path.join(REPO, "tests", "fixtures", "locklint_bad.py")

LOCKS = ["BitstreamStore._lock", "DownloadScheduler._cond", "FaultPlan._lock",
         "FleetOverlay._lock", "LaunchCounter._lock", "Overlay._lock",
         "interpreter._builds_lock", "interpreter._capture_lock", "native._build_lock"]
EDGES = ["FleetOverlay._lock -> BitstreamStore._lock",
         "FleetOverlay._lock -> DownloadScheduler._cond",
         "FleetOverlay._lock -> FaultPlan._lock",
         "FleetOverlay._lock -> Overlay._lock",
         "Overlay._lock -> BitstreamStore._lock",
         "Overlay._lock -> DownloadScheduler._cond"]


@pytest.fixture(scope="module")
def real_tree():
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        yield locklint.run([SRC])
    finally:
        os.chdir(cwd)


# ---------------------------------------------------------------------------
# the lock lint
# ---------------------------------------------------------------------------
def test_real_tree_is_clean(real_tree):
    kept, _waived, _lint = real_tree
    assert kept == [], "unallowlisted findings:\n" + "\n".join(
        f.render() for f in kept)


def test_lock_order_graph_is_the_documented_one(real_tree):
    _kept, _waived, lint = real_tree
    graph = lint.lock_graph_summary()
    assert graph["locks"] == LOCKS
    # fleet -> overlay -> {scheduler, store}; nothing points backwards,
    # every other lock is a leaf: no cycle
    assert graph["edges"] == EDGES
    assert not [f for f in lint.findings if f.rule == "lock-order-cycle"]
    doc = locklint.__doc__
    assert all(edge in doc for edge in EDGES)
    assert doc.count(" -> ") == len(EDGES)


def test_every_allowlist_entry_is_load_bearing_and_exact(real_tree):
    """A stale allowlist pattern hides future regressions: each entry must
    match a finding the lint still produces, name one site exactly (no
    wildcard), and carry a written audit."""
    _kept, waived, _lint = real_tree
    patterns = locklint._load_allowlist(locklint.DEFAULT_ALLOWLIST)
    fingerprints = {f.fingerprint for f in waived}
    assert sorted(patterns) == sorted(fingerprints)
    assert len(fingerprints) == len(patterns) == 9
    for pat in patterns:
        assert not set(pat) & set("*?["), f"not an exact fingerprint: {pat}"
        rule, path, qual, detail = pat.split(":", 3)
        assert path.startswith("src/repro_torch/") and qual and detail
    with open(locklint.DEFAULT_ALLOWLIST, encoding="utf-8") as fh:
        blocks = fh.read().split("\n\n")[1:]
    for block in blocks:                       # every entry has its audit
        lines = block.strip().splitlines()
        assert lines[0].startswith("#") and not lines[-1].startswith("#")
    assert {f.rule for f in waived} == {"unlocked-shared-write",
                                        "blocking-call-under-lock"}


def test_both_lints_agree_on_the_bad_fixture():
    from repro.analysis import locklint as jlint

    ours, _w, _l = locklint.run([FIXTURE], allowlist=None)
    theirs, _w, _l = jlint.run([FIXTURE], allowlist=None)
    key = lambda f: (f.rule, f.qualname, f.detail, f.line)
    assert sorted(map(key, ours)) == sorted(map(key, theirs))
    rules = {f.rule for f in ours}
    assert rules == {"lock-order-cycle", "unlocked-shared-write",
                     "blocking-call-under-lock"}
    by_rule = {f.rule: f for f in ours}
    cycle = by_rule["lock-order-cycle"]
    assert "Left._lock" in cycle.detail and "Right._lock" in cycle.detail
    assert by_rule["unlocked-shared-write"].detail == "Right._table"
    assert by_rule["blocking-call-under-lock"].detail == "sleep"


def test_fingerprints_are_stable_identifiers():
    kept, _waived, _lint = locklint.run([FIXTURE], allowlist=None)
    for f in kept:
        rule, path, qual, detail = f.fingerprint.split(":", 3)
        assert rule == f.rule and qual == f.qualname and detail == f.detail
        assert path.endswith("locklint_bad.py")
        assert str(f.line) not in (rule, detail)


def test_module_locks_and_shadowed_names(tmp_path):
    """Module-level locks are locks (the port's build and capture locks),
    and a call through a parameter never resolves to a module function of
    the same name elsewhere (the false edge a flat name table gives)."""
    src = tmp_path / "mod.py"
    src.write_text(textwrap.dedent('''
        import threading
        import time

        _lock = threading.Lock()


        def build():
            with _lock:
                time.sleep(1)


        class Holder:
            def __init__(self):
                self._lock = threading.Lock()

            def run(self, build):
                with self._lock:
                    return build()
    '''))
    kept, _w, lint = locklint.run([str(src)], allowlist=None)
    assert [(f.rule, f.qualname, f.detail) for f in kept] == [
        ("blocking-call-under-lock", "build", "sleep")]
    graph = lint.lock_graph_summary()
    assert graph["locks"] == ["Holder._lock", "mod._lock"]
    assert graph["edges"] == []


def test_cli_expect_rules_and_clean_tree(capsys):
    rc = locklint.main([FIXTURE, "--expect-rules",
                        "lock-order-cycle,unlocked-shared-write,"
                        "blocking-call-under-lock"])
    assert rc == 0
    assert locklint.main([FIXTURE, "--expect-rules", "no-such-rule"]) == 1
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        assert locklint.main([SRC]) == 0
    finally:
        os.chdir(cwd)


# ---------------------------------------------------------------------------
# the invariant checkers
# ---------------------------------------------------------------------------
def _overlay_with_residents(n=2, **kwargs):
    ov = Overlay(3, 3, **kwargs)
    fns = []
    x = torch.ones((4, 4))
    for i in range(n):
        scale = float(i + 1)
        f = ov.jit(lambda a, b, s=scale: torch.sum(a * b) * s,
                   name=f"chk{i}", tile_budget=2)
        f(x, x)
        fns.append(f)
    return ov, fns, x


def _rules(violations):
    return {v.rule for v in violations}


def test_checkers_green_on_live_overlay():
    ov, _fns, x = _overlay_with_residents()
    assert check.check_overlay(ov) == []
    ov.defragment()
    assert check.check_overlay(ov) == []
    ov.reconfigure(relocate=True)
    assert check.check_overlay(ov) == []
    _fns[1].specialize(x, x)
    assert check.check_overlay(ov) == []
    ov.evict("chk0")
    assert check.check_overlay(ov) == []
    ov.close()


def test_fabric_rules_fire_on_corruption():
    ov, _fns, _x = _overlay_with_residents()
    a, b = list(ov.fabric._residents.values())[:2]

    keep = a.tiles
    a.tiles = b.tiles
    found = _rules(check.check_fabric(ov.fabric))
    assert {"fabric/tile-overlap", "fabric/placement-tiles",
            "fabric/occupants"} <= found
    a.tiles = keep

    a.tiles = frozenset([(99, 99)])
    assert "fabric/tile-bounds" in _rules(check.check_fabric(ov.fabric))
    a.tiles = keep

    gen = a.generation
    a.generation = 0
    assert "fabric/generation-monotone" in _rules(check.check_fabric(ov.fabric))
    a.generation = gen

    a.live = False
    assert "fabric/dead-resident" in _rules(check.check_fabric(ov.fabric))
    a.live = True

    ov.fabric._residents["bogus"] = a
    assert "fabric/key-mismatch" in _rules(check.check_fabric(ov.fabric))
    del ov.fabric._residents["bogus"]

    assert check.check_fabric(ov.fabric) == []
    ov.close()


def test_entry_rules_fire_on_corruption():
    ov, _fns, _x = _overlay_with_residents(n=1)
    res = next(iter(ov.fabric._residents.values()))

    cost = res.route_cost
    res.route_cost = cost + 7
    assert "entry/route-cost" in _rules(check.check_residency(ov))
    res.route_cost = cost

    zh = res.zero_hop
    res.zero_hop = not zh
    assert "entry/zero-hop" in _rules(check.check_residency(ov))
    res.zero_hop = zh

    routes = res.routes
    res.routes = torch.cat([routes, routes])
    assert "entry/routes-length" in _rules(check.check_residency(ov))
    res.routes = routes

    placement = res.placement
    res.placement = dataclasses.replace(
        placement, edge_hops={e: 40 for e in placement.edge_hops})
    assert "entry/hop-bounds" in _rules(check.check_residency(ov))
    res.placement = placement

    tier = res.tier
    res.tier = "turbo"
    assert "entry/spec-tier" in _rules(check.check_residency(ov))
    res.tier = "specialized"           # without spec_fn: also a violation
    assert "entry/spec-tier" in _rules(check.check_residency(ov))
    res.tier = tier

    assert check.check_residency(ov) == []
    ov.close()


def test_cache_rules_fire_on_corruption():
    ov, _fns, _x = _overlay_with_residents(n=1)
    res = next(iter(ov.fabric._residents.values()))

    ov.cache._routes["ghost|[(0, (0, 0))]"] = object()
    assert "cache/route-owner" in _rules(check.check_cache(ov))
    del ov.cache._routes["ghost|[(0, (0, 0))]"]

    stale = f"{res.rid}|stale-desc"
    ov.cache._routes[stale] = object()
    assert "cache/route-owner" in _rules(check.check_cache(ov))
    del ov.cache._routes[stale]

    ov.cache._specialized["gone:0000|spec|0,0"] = object()
    assert "cache/spec-orphan" in _rules(check.check_cache(ov))
    del ov.cache._specialized["gone:0000|spec|0,0"]

    assert check.check_cache(ov) == []
    ov.close()


def test_breaker_rules_fire_on_corruption():
    ov, fns, _x = _overlay_with_residents(n=1)
    (entry,) = fns[0]._entries.values()
    entry.breaker = "ajar"
    assert "entry/breaker-state" in _rules(check.check_breakers(ov))
    entry.breaker = "open"
    assert check.check_breakers(ov) == []        # it has a fallback
    closed, acc = entry.closed, entry.acc
    entry.closed = entry.acc = None
    assert "entry/breaker-fallback" in _rules(check.check_breakers(ov))
    entry.closed, entry.acc, entry.breaker = closed, acc, "closed"
    assert check.check_overlay(ov) == []
    ov.close()


def test_ensure_raises_first_violation_with_rule():
    v = [check.Violation("fabric/tile-overlap", "tile (0, 0) double-claimed"),
         check.Violation("entry/route-cost", "later")]
    with pytest.raises(InvariantError) as err:
        check.ensure(v)
    assert err.value.rule == "fabric/tile-overlap"
    assert "double-claimed" in str(err.value)
    check.ensure([])


def test_describe_schema_is_stable_and_the_references(tmp_path):
    """The port's ``describe()`` keeps the reference's schema: the frozen
    key sets are the reference's (``mesh`` adds no key to the report there,
    so nothing is subtracted), and a live overlay, with and without a store,
    passes the check."""
    from repro.analysis import check as jcheck

    assert check._OVERLAY_DESCRIBE_KEYS == jcheck._OVERLAY_DESCRIBE_KEYS
    assert check._FABRIC_DESCRIBE_KEYS == jcheck._FABRIC_DESCRIBE_KEYS
    assert check._RESIDENT_DESCRIBE_KEYS == jcheck._RESIDENT_DESCRIBE_KEYS
    assert check._SPEC_EXTRA_KEYS == jcheck._SPEC_EXTRA_KEYS
    assert "mesh" not in jcheck._OVERLAY_DESCRIBE_KEYS
    ov, _fns, _x = _overlay_with_residents()
    assert check.check_overlay_describe(ov) == []
    ov.close()
    st = Overlay(3, 3, store_path=str(tmp_path))
    st.assemble(saxpy_graph(16))
    assert check.check_overlay_describe(st) == []
    assert set(st.describe()) == jcheck._OVERLAY_DESCRIBE_KEYS
    st.close()


def test_describe_schema_checker_detects_drift():
    ov, _fns, _x = _overlay_with_residents(n=1)
    d = ov.describe()
    orig_describe = ov.describe

    def drifted():
        out = dict(orig_describe())
        out.pop("fabric")
        out["fabrik"] = d["fabric"]
        return out

    ov.describe = drifted
    try:
        rules = {v.rule for v in check.check_overlay_describe(ov)}
        assert "describe/overlay-schema" in rules
        assert "describe/fabric-schema" in rules
    finally:
        ov.describe = orig_describe
    assert check.check_overlay_describe(ov) == []
    ov.close()


# ---------------------------------------------------------------------------
# the sanitizer
# ---------------------------------------------------------------------------
def _build(n_fns, **overlay_kwargs):
    ov = Overlay(3, 3, sanitize=True, **overlay_kwargs)
    x = torch.ones((4, 4))
    fns = []
    for i in range(n_fns):
        scale = float(i + 1)
        fns.append(ov.jit(lambda a, b, s=scale: torch.sum(a * b) * s,
                          name=f"race{i}", tile_budget=2))
    return ov, fns, x


def test_sanitizer_fires_at_the_admit_edge():
    ov, fns, x = _build(1)
    fns[0](x, x)
    res = next(iter(ov.fabric._residents.values()))
    res.generation = 0                      # breaks generation monotonicity
    g = ov.jit(lambda a, b: torch.sum(a + b), name="fresh", tile_budget=2)
    with pytest.raises(InvariantError) as err:
        g(x, x)                             # the admission runs the checkers
    assert err.value.rule == "fabric/generation-monotone"
    ov.close()


def test_sanitizer_fires_at_the_evict_edge():
    ov, fns, x = _build(2)
    fns[0](x, x)
    fns[1](x, x)
    residents = list(ov.fabric._residents.values())
    residents[0].tiles = frozenset([(99, 99)])   # off-grid claim
    with pytest.raises(InvariantError) as err:
        ov.evict("race1")                   # the evict edge sees resident 0
    assert err.value.rule in ("fabric/tile-bounds", "fabric/placement-tiles")
    ov.close()


def test_sanitizer_fires_at_the_relocate_and_spec_commit_edges():
    ov, fns, x = _build(2)
    fns[0](x, x)
    fns[1](x, x)
    a, b = list(ov.fabric._residents.values())
    a.route_cost += 5                       # a stale cached route cost
    with pytest.raises(InvariantError) as err:
        ov.relocate(b.rid, b.placement)     # the move re-checks every resident
    assert err.value.rule == "entry/route-cost"
    a.route_cost -= 5
    ov.cache._routes["ghost|x"] = object()
    with pytest.raises(InvariantError) as err:
        fns[1].specialize(x, x)             # the spec commit edge
    assert err.value.rule == "cache/route-owner"
    del ov.cache._routes["ghost|x"]
    assert check.check_overlay(ov) == []
    ov.close()


def test_sanitize_defaults_off_and_env_opt_in(monkeypatch):
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    assert Overlay(2, 2).sanitize is False
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    assert Overlay(2, 2).sanitize is True
    monkeypatch.setenv("REPRO_SANITIZE", "0")
    assert Overlay(2, 2).sanitize is False
    monkeypatch.delenv("REPRO_SANITIZE")
    assert Overlay(2, 2, sanitize=True).sanitize is True


def test_sanitizer_adds_no_work_when_disabled(monkeypatch):
    """The hooks are flag-guarded: with sanitize off, a dispatch, admit and
    evict cycle never reaches the checker."""
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    ov = Overlay(3, 3)
    calls = []
    monkeypatch.setattr(Overlay, "_sanity_check",
                        lambda self: calls.append(1))
    f = ov.jit(lambda a, b: torch.sum(a * b), name="off", tile_budget=2)
    x = torch.ones((4, 4))
    f(x, x)
    f(x, x)
    ov.defragment()
    ov.evict("off")
    assert calls == []
    on = Overlay(3, 3, sanitize=True)
    on.jit(lambda a, b: torch.sum(a * b), name="on", tile_budget=2)(x, x)
    assert calls                            # the same edges, sanitizer on
    ov.close()
    on.close()


def test_sanitizer_quiet_under_light_race():
    """4 dispatch threads x 40 calls against 24 mutations (evict,
    defragment, prefetch, relocating reconfigure): no violation on the real
    runtime.  Traced first on this thread: make_fx is not thread-safe."""
    ov, fns, x = _build(4)
    for f in fns:
        f.lower(x, x)
    errors = []
    start = threading.Barrier(len(fns) + 1)

    def dispatcher(f):
        start.wait()
        for _ in range(40):
            try:
                f(x, x)
            except InvariantError as exc:
                errors.append(exc)
                return
            except PlacementError:
                pass

    def mutator():
        start.wait()
        for i in range(24):
            try:
                op = i % 4
                if op == 0:
                    ov.evict(f"race{i % len(fns)}")
                elif op == 1:
                    ov.defragment()
                elif op == 2:
                    fns[i % len(fns)].prefetch(x, x)
                else:
                    ov.reconfigure(relocate=True, prefetch=False)
            except InvariantError as exc:
                errors.append(exc)
                return
            except PlacementError:
                pass

    threads = [threading.Thread(target=dispatcher, args=(f,)) for f in fns]
    threads.append(threading.Thread(target=mutator))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads), "stress harness hung"
    assert errors == [], f"sanitizer fired on the real runtime: {errors[0]}"
    ov.close()


def test_sanitizer_quiet_across_planned_repack():
    """defragment()/reconfigure(relocate=True) move residents one at a time
    with ``ignore=plan_rids``; mid-plan the ledger passes through legal
    transient overlap, which the per-move hook must not flag."""
    ov, fns, x = _build(4)
    for f in fns:
        try:
            f(x, x)
        except PlacementError:
            pass
    ov.evict("race0")
    fns[1](x, x)
    ov.defragment()
    ov.reconfigure(relocate=True, prefetch=False)
    assert check.check_overlay(ov) == []
    ov.close()


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------
def test_report_on_the_cpu_exits_zero(capsys, monkeypatch):
    from repro_torch.analysis.__main__ import main

    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    assert main(["report", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for section in ("== locklint ==", "== live checkers (cpu) ==",
                    "== bitstream store ==", "== chaos (injected faults) =="):
        assert section in out
    assert "fleet records: 0 violation(s)" in out
    assert "fleet describe(): 0 violation(s)" in out
    assert "replication(s)" in out and "not ported" not in out
    assert out.rstrip().endswith("PASS") and "FAIL" not in out


def test_report_static_only(capsys):
    from repro_torch.analysis.__main__ import main

    assert main(["report", "--static-only"]) == 0
    out = capsys.readouterr().out
    assert "order:  Overlay._lock -> BitstreamStore._lock" in out
