"""``python -m repro_torch.analysis report`` — one-screen invariant audit.

Runs the concurrency lint over ``src/repro_torch`` and prints the
lock-order graph, then spins up small live overlays on the device
(``cuda`` unless ``--device cpu``): one exercised through admit, dispatch,
defragment, relocating reconfigure and evict under the sanitizer; a
two-member fleet under the sanitizer, hot enough to replicate; the
bitstream store through a cold boot, a warm boot and a garbled entry; and
a seeded fault plan that fails every download.  Prints per-rule pass/fail
counts and the kernel launches the live sections made; the exit status is
non-zero on any failure.

The accelerator audited is the paper's ``sum(a * b)`` as the LARGE
``vmul_reduce`` bitstream (``kernels.ops.vmul_reduce``): on the card it
launches the CUDA kernel, on the CPU its plain version.

Port of ``repro/analysis/__main__.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import warnings
from collections import Counter

from . import locklint

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _static_section(paths: list[str]) -> int:
    kept, waived, lint = locklint.run(paths)
    graph = lint.lock_graph_summary()
    print("== locklint ==")
    print(f"  locks:  {', '.join(graph['locks']) or '(none)'}")
    for edge in graph["edges"]:
        print(f"  order:  {edge}")
    per_rule = Counter(f.rule for f in kept)
    for rule in ("lock-order-cycle", "unlocked-shared-write",
                 "blocking-call-under-lock"):
        n = per_rule.get(rule, 0)
        print(f"  {'FAIL' if n else 'ok  '}  {rule}: {n} finding(s)")
    if waived:
        print(f"  note: {len(waived)} audited finding(s) allowlisted")
    for f in kept:
        print(f"    {f.render()}")
    return len(kept)


def _dot(a, b):
    from repro_torch.kernels import ops

    return ops.vmul_reduce(a, b)


def _vectors(device, n: int = 4096):
    import torch

    gen = torch.Generator().manual_seed(0)
    a = torch.rand(n, generator=gen).to(device)
    b = torch.rand(n, generator=gen).to(device)
    return a, b


def _same(x, y) -> bool:
    import torch

    return bool(torch.equal(x, y))


def _report(violations_by_section) -> int:
    failures = 0
    for name, violations in violations_by_section:
        print(f"  {'FAIL' if violations else 'ok  '}  {name}: "
              f"{len(violations)} violation(s)")
        for v in violations:
            print(f"    {v.rule}: {v.message}")
        failures += len(violations)
    return failures


def _live_section(device) -> int:
    from repro_torch.core.fleet import FleetOverlay
    from repro_torch.core.overlay import Overlay

    from . import check

    print(f"== live checkers ({device}) ==")
    a, b = _vectors(device)
    ov = Overlay(3, 3, sanitize=True)
    f = ov.jit(_dot, name="audit")
    want = f(a, b)
    ov.defragment()
    ov.reconfigure(relocate=True)
    got = f(a, b)
    sections = [
        ("fabric ledger", check.check_fabric(ov.fabric)),
        ("entry/ISA", check.check_residency(ov)),
        ("cache tables", check.check_cache(ov)),
        ("describe() schema", check.check_overlay_describe(ov)),
    ]
    ov.evict("audit")
    sections.append(("post-evict", check.check_overlay(ov)))
    ov.close()

    # a window of 4 and replicate_after 2: the hot signature gains a replica
    # at the first rebalance, and every rebalance runs the fleet checkers
    fleet = FleetOverlay(2, rows=3, cols=3, window=4, replicate_after=2,
                         drain_below=1, sanitize=True)
    g = fleet.jit(_dot, name="audit_fleet")
    outs = [g(a, b) for _ in range(12)]
    with fleet._lock:
        sections.append(("fleet records", check.check_fleet(fleet)))
    sections.append(("fleet describe()", check.check_fleet_describe(fleet)))
    stats = fleet.stats
    routed = fleet.describe()["fleet"]["routed_per_member"]
    fleet.close()
    failures = _report(sections)
    ok = _same(want, got)
    failures += 0 if ok else 1
    print(f"  {'ok  ' if ok else 'FAIL'}  bit-identical across the moves")
    ok = (stats.replications >= 1 and min(routed) > 0
          and all(_same(o, want) for o in outs))
    failures += 0 if ok else 1
    print(f"  {'ok  ' if ok else 'FAIL'}  fleet: {stats.replications} replication(s), "
          f"routed per member {routed}, {stats.rebalances} sanitized rebalance(s), "
          f"bit-identical={all(_same(o, want) for o in outs)}")
    return failures


def _store_section(device) -> int:
    """The persistent bitstream store end to end: a cold boot persists, a
    warm boot loads, a garbled entry builds cold.  Prints the store's own
    stats, so drift (format bumps, silent failures) shows here."""
    from repro_torch.core.overlay import Overlay
    from repro_torch.core.store import BitstreamStore

    print("== bitstream store ==")
    failures = 0
    a, b = _vectors(device)
    with tempfile.TemporaryDirectory(prefix="repro-report-store-") as d:
        ov = Overlay(3, 3, store_path=d)
        cold = ov.jit(_dot, name="audit_store")(a, b)
        ov.drain()
        ov.close()
        saves = ov.store.stats.saves
        ok = saves >= 1
        failures += 0 if ok else 1
        print(f"  {'ok  ' if ok else 'FAIL'}  cold boot persisted: "
              f"{saves} save(s), {len(ov.store.keys())} entr(ies)")

        ov2 = Overlay(3, 3, store_path=d)
        warm = ov2.jit(_dot, name="audit_store")(a, b)
        hits = ov2.cache.stats.store_hits
        ok = hits >= 1 and _same(cold, warm)
        failures += 0 if ok else 1
        print(f"  {'ok  ' if ok else 'FAIL'}  warm boot loaded: "
              f"{hits} store hit(s), "
              f"{ov2.cache.stats.store_load_seconds * 1e3:.1f} ms, "
              f"bit-identical={_same(cold, warm)}")
        ov2.close()

        store = BitstreamStore(d)
        for k in store.keys():
            with open(store._path_for(k), "r+b") as fh:   # garble payloads
                fh.seek(-1, 2)
                last = fh.read(1)
                fh.seek(-1, 2)
                fh.write(bytes([last[0] ^ 0xFF]))
        ov3 = Overlay(3, 3, store_path=d)
        garbled = ov3.jit(_dot, name="audit_store")(a, b)
        ok = (ov3.cache.stats.store_hits == 0
              and ov3.store.stats.load_failures >= 1 and _same(cold, garbled))
        failures += 0 if ok else 1
        print(f"  {'ok  ' if ok else 'FAIL'}  garbled entry cold-compiled: "
              f"{ov3.store.stats.load_failures} load failure(s), "
              f"bit-identical={_same(cold, garbled)}")
        ov3.close()
    return failures


def _chaos_section(device) -> int:
    """The failure path end to end: a seeded fault plan fails every
    download, the overlay degrades to its eager fallback (zero dropped
    calls), opens the breaker and keeps every invariant.  Prints the
    failure ledger, so retry/breaker drift shows here."""
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.overlay import Overlay

    from . import check

    print("== chaos (injected faults) ==")
    failures = 0
    a, b = _vectors(device)
    plan = FaultPlan(seed=11, download_failure_rate=1.0)
    ov = Overlay(3, 3, faults=plan)
    f = ov.jit(_dot, name="audit_chaos")
    baseline = Overlay(3, 3)
    want = baseline.jit(_dot, name="audit_chaos")(a, b)
    baseline.close()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        outs = [f(a, b) for _ in range(12)]
    ledger = ov.failure_ledger()
    ok = all(_same(o, want) for o in outs)
    failures += 0 if ok else 1
    print(f"  {'ok  ' if ok else 'FAIL'}  degraded calls bit-identical: "
          f"{len(outs)} call(s), {ov.stats.fallback_calls} fallback(s)")
    ok = (ledger["download_failures"] >= ov.breaker_threshold
          and ledger["breaker_opens"] >= 1 and ledger["breakers_open"] >= 1)
    failures += 0 if ok else 1
    print(f"  {'ok  ' if ok else 'FAIL'}  breaker opened: "
          f"{ledger['download_failures']} download failure(s), "
          f"{ledger['download_retries']} retr(ies), "
          f"{ledger['breaker_opens']} open(s), "
          f"{ledger['breaker_probes']} probe(s)")
    failures += _report([("invariants under faults", check.check_overlay(ov))])
    replay = FaultPlan(seed=11, download_failure_rate=1.0)
    for ev in plan.events():
        replay.fires(ev.channel, ev.key)
    # replaying the observed (channel, key) sequence fires faults at the
    # same ordinals: the determinism the chaos tests lean on
    ok = replay.events() == plan.events() and len(plan.events()) >= 1
    failures += 0 if ok else 1
    print(f"  {'ok  ' if ok else 'FAIL'}  fault schedule deterministic: "
          f"{len(plan.events())} event(s)")
    ov.close()
    return failures


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.analysis")
    sub = ap.add_subparsers(dest="cmd", required=True)
    rep = sub.add_parser("report", help="one-screen invariant audit")
    rep.add_argument("paths", nargs="*", default=None,
                     help="lint roots (default: the repro_torch package)")
    rep.add_argument("--static-only", action="store_true",
                     help="skip the live overlay exercise")
    rep.add_argument("--device", default=None,
                     help="torch device of the live sections (default: cuda)")
    args = ap.parse_args(argv)

    failures = _static_section(args.paths or [_PKG])
    if not args.static_only:
        from repro_torch.device import resolve_device

        device = resolve_device(args.device)
        failures += _live_section(device)
        failures += _store_section(device)
        failures += _chaos_section(device)
        from repro_torch.kernels import ops

        launches = {c.name: c.count for c in ops.LAUNCH_COUNTERS}
        for c in ops.LAUNCH_COUNTERS:
            launches.update({f"{c.name}/{v}": n for v, n in c.by_variant.items()})
        print(f"kernel launches {json.dumps(launches)}")
    print("PASS" if failures == 0 else f"FAIL ({failures} problem(s))")
    return 0 if failures == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
