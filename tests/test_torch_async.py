"""The port's asynchronous overlay on the CPU: the download pipeline, the
failure model and the thread safety of the kernels' host side.

A miss is served by the fallback (the traced function run eagerly) while
the kernel builds on a scheduler worker; results must be bit-identical
before and after the swap.  Downloads are gated by replacing the instance
attribute ``ov._compile_bitstream``, as the reference's tests do.  The
failure model: a breaker that opens at ``breaker_threshold`` failures and
closes after a good probe, dispatch failures and resident losses served
bit-identically, a relocation during a pending specialization dropping the
build, and a failure ledger with the reference's keys.  Last, the kernels'
launch counters under many threads and the build lock with a stand-in
compiler.  The card's side (a CUDA-graph capture on a worker while decode
ticks run) is in ``tests/test_torch_specialization.py``.
"""

import os
import stat
import sys
import threading
import warnings

import pytest
import torch

from repro.core import Overlay as JOverlay
from repro_torch.core import FaultPlan, Overlay, PlacementPolicy, place
from repro_torch.kernels import native

WAIT_S = 30.0
X = torch.arange(8.0)
Y = torch.ones(8)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _mul(a, b):
    return torch.sum(a * b) * 2.0


def _gate_downloads(ov):
    """Hold every background kernel build until the returned event is set."""
    gate = threading.Event()
    build = ov._compile_bitstream

    def gated(pending):
        assert gate.wait(WAIT_S)
        return build(pending)

    ov._compile_bitstream = gated
    return gate


# ---------------------------------------------------------------------------
# the download pipeline
# ---------------------------------------------------------------------------
def test_fallback_serves_then_the_resident_bit_identically():
    ov = Overlay(3, 3, async_downloads=True)
    gate = _gate_downloads(ov)
    f = ov.jit(lambda x, w: torch.sqrt(torch.sum((x * w) ** 2) / x.numel()), name="rms")
    x, w = torch.linspace(0.0, 1.0, 512), torch.linspace(1.0, 2.0, 512)
    y_fallback = f(x, w)                    # served while the build is held
    assert ov.stats.fallback_calls == 1 and len(ov.fabric) == 1
    assert f.accelerator(x, w) is None      # regions held, kernel pending
    f(x, w)                                 # in flight: the fallback again
    assert ov.stats.fallback_calls == 2
    assert ov.scheduler.stats.coalesced == 0 and ov.scheduler.outstanding() == 1
    gate.set()
    assert ov.drain(WAIT_S)
    y_resident = f(x, w)
    assert ov.stats.fallback_calls == 2     # the resident serves now
    assert torch.equal(y_resident, y_fallback)
    acc = f.accelerator(x, w)
    assert acc is not None and ov.resident_current(acc)
    assert ov.fabric.download_cost(acc.resident_id) > 0.0
    assert torch.equal(Overlay(3, 3).jit(f.fn)(x, w), y_fallback)   # = sync mode
    ov.close()


def test_prefetch_hit_accounting():
    ov = Overlay(3, 3, async_downloads=True)
    scale = ov.jit(lambda x: x * 3.0, name="scale")
    x = torch.ones(64)
    assert scale.prefetch(x) is not None and ov.stats.prefetches == 1
    assert ov.drain(WAIT_S)
    assert torch.equal(scale(x), x * 3.0)
    assert ov.stats.prefetch_hits == 1 and ov.stats.fallback_calls == 0
    scale(x)
    assert ov.stats.prefetch_hits == 1      # later hits are not re-counted
    assert scale.prefetch(x) is None        # already resident
    other = Overlay(3, 3, async_downloads=True)
    with pytest.raises(ValueError):
        other.prefetch(scale, x)
    ov.close()
    other.close()


def test_async_defaults_follow_async_downloads():
    ov = Overlay(3, 3, async_downloads=True)
    assert ov.cost_aware_reclaim and ov._auto_specialize
    sync = Overlay(3, 3)
    assert not sync.cost_aware_reclaim and not sync._auto_specialize
    assert sync.scheduler.describe()["workers"] == 0
    ov.close()


def test_auto_specialize_rides_the_low_lane():
    ov = Overlay(3, 3, async_downloads=True)
    f = ov.jit(lambda x: x * 3.0 + 1.0, name="hot")
    x = torch.ones(64)
    y0 = f(x)                               # fallback, download queued
    assert ov.drain(WAIT_S)
    assert torch.equal(f(x), y0)            # generic; zero-hop trigger queues
    assert ov.drain(WAIT_S)
    (res,) = ov.fabric.residents.values()
    assert res.zero_hop and res.tier == "specialized"
    assert ov.scheduler.stats.low_jobs == 1
    assert torch.equal(f(x), y0)
    assert ov.cache.spec_stats.specialized_hits == 1
    ov.close()


def test_reconfigure_flushes_and_prefetches_known_signatures():
    ov = Overlay(3, 3, async_downloads=True)
    f = ov.jit(lambda x: x * 5.0, name="x5")
    x = torch.ones(32)
    f(x)
    assert ov.drain(WAIT_S)
    ov.reconfigure(policy=PlacementPolicy.STATIC)
    assert ov.drain(WAIT_S)
    assert len(ov.fabric) == 1              # re-downloaded in the background
    before = ov.stats.fallback_calls
    assert torch.equal(f(x), x * 5.0)
    assert ov.stats.fallback_calls == before and ov.stats.prefetch_hits >= 1
    ov.close()


def test_evicted_resident_is_not_resurrected_by_a_late_download():
    ov = Overlay(3, 3, async_downloads=True)
    gate = _gate_downloads(ov)
    f = ov.jit(lambda x: x + 1.0, name="late")
    x = torch.ones(8)
    f(x)
    ov.evict("late")
    gate.set()
    assert ov.drain(WAIT_S)
    assert len(ov.fabric) == 0 and len(ov.cache) == 0
    assert ov.scheduler.stats.dropped_stale + ov.scheduler.stats.cancelled >= 1
    ov.close()


def test_calls_are_served_after_close():
    ov = Overlay(3, 3, async_downloads=True)
    f = ov.jit(lambda x: x - 3.0, name="dec3")
    x = torch.ones(16)
    ov.close()
    for _ in range(3):
        assert torch.equal(f(x), x - 3.0)
    assert ov.stats.fallback_calls == 3
    assert ov.scheduler.describe()["submitted"] == 0


# ---------------------------------------------------------------------------
# the failure model
# ---------------------------------------------------------------------------
def test_breaker_opens_at_three_failures_and_closes_after_a_good_probe():
    want = _mul(X, Y)
    ov = Overlay(3, 3, async_downloads=True,
                 faults=FaultPlan(5, download_failure_rate=1.0), breaker_probe_after=2)
    f = ov.jit(_mul, name="healing")
    with pytest.warns(RuntimeWarning):
        for _ in range(8):
            assert torch.equal(f(X, Y), want)
            assert ov.drain(WAIT_S)
    led = ov.failure_ledger()
    assert led["breaker_opens"] == 1 and led["breakers_open"] == 1
    assert led["download_failures"] >= ov.breaker_threshold == 3
    assert led["download_retries"] >= 2 and led["breaker_probes"] >= 1
    assert ov.stats.fallback_calls == 8
    (entry,) = f._entries.values()
    assert entry.acc is None and entry.record is None
    ov.faults = None                        # the outage ends
    for _ in range(8):
        assert torch.equal(f(X, Y), want)
        assert ov.drain(WAIT_S)
    led = ov.failure_ledger()
    assert led["breaker_closes"] == 1 and led["breakers_open"] == 0
    assert entry.acc is not None and entry.record is not None
    ov.close()


def test_sync_overlay_degrades_to_the_fallback_and_opens_the_breaker():
    want = _mul(X, Y)
    ov = Overlay(3, 3, faults=FaultPlan(11, download_failure_rate=1.0))
    f = ov.jit(_mul, name="doomed")
    with pytest.warns(RuntimeWarning):
        outs = [f(X, Y) for _ in range(12)]
    assert all(torch.equal(o, want) for o in outs)
    led = ov.failure_ledger()
    assert led["breaker_opens"] == 1 and led["breakers_open"] == 1
    assert led["breaker_probes"] >= 1 and ov.stats.fallback_calls == 12
    assert ov.scheduler.describe()["submitted"] == 0


@pytest.mark.parametrize("asynchronous", [False, True])
@pytest.mark.parametrize("channel", ["dispatch", "resident_loss"])
def test_dispatch_faults_are_served_bit_identically(asynchronous, channel):
    rate = {f"{channel}_failure_rate" if channel == "dispatch"
            else f"{channel}_rate": 1.0}
    ov = Overlay(3, 3, async_downloads=asynchronous, faults=FaultPlan(2, **rate))
    f = ov.jit(_mul, name="flaky")
    want = _mul(X, Y)
    for _ in range(6):
        assert torch.equal(f(X, Y), want)
        assert ov.drain(WAIT_S)
    led = ov.failure_ledger()
    if channel == "dispatch":
        assert led["dispatch_failures"] >= 1
        assert led["dispatch_fallbacks"] == led["dispatch_failures"]
    else:
        assert led["resident_losses"] >= 1
    assert all(r.dispatch_failures == 0 for r in ov.fabric.residents.values())
    ov.close()


def test_relocation_during_a_pending_specialization_drops_it():
    ov = Overlay(3, 3, async_downloads=True, large_fraction=0.0, auto_specialize=False)
    gate, started = threading.Event(), threading.Event()
    build = ov._compile_specialized_tier

    def gated(pending):
        started.set()
        assert gate.wait(WAIT_S)
        return build(pending)

    ov._compile_specialized_tier = gated
    f = ov.jit(lambda x, y: x * y + 1.0, name="mover", tile_budget=2)
    x = torch.linspace(0.0, 1.0, 16)
    y0 = f(x, x)
    assert ov.drain(WAIT_S)
    f.specialize(x, x)                      # low lane; the build is held
    assert started.wait(WAIT_S)
    (entry,) = f._entries.values()
    res = ov.fabric.get(entry.acc.resident_id)
    assert res.spec_pending
    g = entry.lowered.graph
    ov.relocate(g, place(g, ov.grid, ov.policy,
                         occupied=set(ov.fabric.occupied()) | set(res.tiles),
                         max_tiles=2))
    gate.set()
    assert ov.drain(WAIT_S)
    assert ov.scheduler.stats.dropped_stale == 1
    assert ov.cache.spec_stats.specializations == 0
    assert res.tier == "generic" and not res.spec_pending
    assert torch.equal(f(x, x), y0)
    # a build that reaches its commit after a move is refused by the exact
    # generation check
    snap = ov._spec_snapshot_locked(entry, res, None)
    exe = build(snap)
    ov.relocate(g, place(g, ov.grid, ov.policy,
                         occupied=set(ov.fabric.occupied()) | set(res.tiles),
                         max_tiles=2))
    assert ov._commit_specialized(snap, exe, 0.0) is None
    assert ov.cache.spec_stats.dropped_stale == 1 and res.tier == "generic"
    assert torch.equal(f(x, x), y0)
    ov.close()


def test_download_deadline_fails_a_stuck_download():
    ov = Overlay(3, 3, async_downloads=True,
                 faults=FaultPlan(8, slow_download_rate=1.0, slow_seconds=3.0),
                 download_deadline=0.1)
    f = ov.jit(_mul, name="stuck")
    with pytest.warns(RuntimeWarning):
        assert torch.equal(f(X, Y), _mul(X, Y))
        assert ov.drain(timeout=WAIT_S)
    assert ov.failure_ledger()["timed_out_downloads"] == 1
    ov.close(drain_timeout=0.1)


def test_failure_ledger_has_the_reference_keys():
    jov = JOverlay(3, 3)
    ov = Overlay(3, 3, async_downloads=True, faults=FaultPlan(0), breaker_threshold=4,
                 retry_backoff=2, breaker_probe_after=3, download_deadline=5.0,
                 drain_timeout=1.0, download_workers=2)
    assert list(ov.failure_ledger()) == list(jov.failure_ledger())
    desc = ov.describe()
    assert desc["failures"] == ov.failure_ledger() and desc["async_downloads"]
    assert set(desc["scheduler"]) == set(jov.describe()["scheduler"])
    jov.close()
    ov.close()
    with pytest.raises(ValueError):
        Overlay(3, 3, retry_backoff=0)


def test_fault_errors_never_escape_the_public_api():
    plan = FaultPlan(21, download_failure_rate=0.5, dispatch_failure_rate=0.3,
                     resident_loss_rate=0.3)
    ov = Overlay(3, 3, async_downloads=True, faults=plan)
    f = ov.jit(_mul, name="storm")
    want = _mul(X, Y)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for i in range(20):
            assert torch.equal(f(X, Y), want)
            if i % 3 == 0:
                assert ov.drain(WAIT_S)
    assert ov.drain(WAIT_S)
    assert plan.events()                    # the storm fired
    ov.close()


# ---------------------------------------------------------------------------
# the kernels' host side under threads
# ---------------------------------------------------------------------------
def test_launch_counter_is_exact_under_many_threads():
    counter = native.LaunchCounter("probe", ("a", "b"))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def hammer(variant):
            for _ in range(2000):
                counter.add(variant)

        threads = [threading.Thread(target=hammer, args=("ab"[i % 2],))
                   for i in range(2 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    n = len(threads) * 2000
    assert counter.count == n
    assert counter.by_variant == {"a": n // 2, "b": n // 2}


def test_a_recording_thread_books_its_launches_apart():
    counter = native.LaunchCounter("probe", ("a",))
    seen = {}

    def capture():
        with native.recording_launches() as record:
            counter.add("a", 3)
        seen.update(record)

    t = threading.Thread(target=capture)
    t.start()
    counter.add("a")                        # this thread counts as usual
    t.join(WAIT_S)
    assert not t.is_alive()
    assert counter.count == 1 and seen == {(counter, "a"): 3}


def test_concurrent_first_use_builds_each_library_once(tmp_path, monkeypatch):
    """Two threads reach the kernels at once: with a stand-in compiler
    that takes a while, each library is compiled once and loaded once."""
    log = tmp_path / "nvcc.log"
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!/bin/sh\necho \"$@\" >> {log}\nsleep 0.2\n"
                    "while [ $# -gt 0 ]; do [ \"$1\" = -o ] && out=$2; shift; done\n"
                    "echo built > \"$out\"\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    loads = []
    monkeypatch.setattr(native, "build_dir", lambda: tmp_path / "build")
    monkeypatch.setattr(native, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(native.ctypes, "CDLL", lambda path: loads.append(path) or path)
    native._load.cache_clear()
    try:
        got = []
        barrier = threading.Barrier(2)

        def first_use():
            barrier.wait(WAIT_S)
            got.append(native.libraries())

        threads = [threading.Thread(target=first_use) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
        assert not any(t.is_alive() for t in threads)
        assert len(got) == 2 and got[0] is got[1]
        assert len(log.read_text().splitlines()) == len(native.SOURCES)
        assert sorted(loads) == sorted(str(native.library_path(n)) for n in native.SOURCES)
    finally:
        native._load.cache_clear()
