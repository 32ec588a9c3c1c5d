"""The port's download scheduler against the JAX package's.

``repro_torch.core.scheduler`` is a copy of ``repro.core.scheduler`` (pure
Python).  One scripted mix of priority, FIFO, low-lane, coalesced,
cancelled, failed, refused and flushed jobs runs on both: the same jobs run
in the same order, the handles end the same way and the statistics agree
(all but the measured seconds).  Then the watchdog deadline, ``drain`` and a
timed-out ``shutdown`` on the port's scheduler.
"""

import dataclasses
import logging
import threading
import time

import pytest
import torch

from repro.core import scheduler as jsched
from repro_torch.core import scheduler as tsched

WAIT_S = 10.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _script(mod):
    """Run the scripted mix; returns (run order, handle outcomes, stats)."""
    sched = mod.DownloadScheduler(workers=1)
    order, observed = [], []
    gate, started = threading.Event(), threading.Event()

    def work(name, *, block=False, fail=False):
        def run():
            if block:
                started.set()
                assert gate.wait(WAIT_S)
            order.append(name)
            if fail:
                raise RuntimeError(f"{name} failed")
            return name
        return run

    def commit(raw, dt):
        return raw

    def refuse(raw, dt):
        return None                       # the residency went away: stale

    def watch(result, handle):
        observed.append((handle.key, result, handle.status,
                         type(handle.error).__name__ if handle.error else None))

    h = {}
    h["A"] = sched.submit("A", work("A", block=True), commit, on_done=watch)
    assert started.wait(WAIT_S)           # A holds the only worker
    h["B"] = sched.submit("B", work("B"), commit, on_done=watch)
    h["L1"] = sched.submit("L1", work("L1"), commit, low=True, on_done=watch)
    h["B2"] = sched.submit("B", work("B-again"), commit, on_done=watch)   # coalesces
    h["P"] = sched.submit("P", work("P"), commit, priority=True, on_done=watch)
    h["C"] = sched.submit("C", work("C"), commit, on_done=watch)
    h["L2"] = sched.submit("L2", work("L2"), commit, low=True, on_done=watch)
    h["F"] = sched.submit("F", work("F", fail=True), commit, on_done=watch)
    h["S"] = sched.submit("S", work("S"), refuse, on_done=watch)
    h["P2"] = sched.submit("P2", work("P2"), commit, priority=True, on_done=watch)
    with pytest.raises(ValueError):
        sched.submit("X", work("X"), commit, priority=True, low=True)
    assert sched.cancel("C") and sched.cancel("L2")   # queued: never run
    assert sched.cancel("A")                           # running: stale
    assert not sched.cancel("nothing")
    gate.set()
    assert sched.drain(timeout=WAIT_S)

    # a flush: the running job loses its commit, queued ones never run
    gate2, started2 = threading.Event(), threading.Event()

    def blocking():
        started2.set()
        assert gate2.wait(WAIT_S)
        order.append("G")
        return "G"

    h["G"] = sched.submit("G", blocking, commit, on_done=watch)
    assert started2.wait(WAIT_S)
    h["H"] = sched.submit("H", work("H"), commit, on_done=watch)
    h["L3"] = sched.submit("L3", work("L3"), commit, low=True, on_done=watch)
    assert sched.flush() == 3
    gate2.set()
    assert sched.drain(timeout=WAIT_S)
    sched.shutdown(wait=True, timeout=WAIT_S)
    h["late"] = sched.submit("late", work("late"), commit, on_done=watch)
    outcomes = {k: (v.status, v.result, type(v.error).__name__ if v.error else None,
                    v.done()) for k, v in h.items()}
    stats = dataclasses.asdict(sched.stats)
    stats.pop("download_seconds")
    return order, outcomes, sorted(observed, key=repr), stats


def test_scripted_mix_matches_the_reference():
    want = _script(jsched)
    got = _script(tsched)
    assert got[0] == want[0] == ["A", "P2", "P", "B", "F", "S", "L1", "G"]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[3] == want[3]
    assert got[3]["coalesced"] == 1 and got[3]["cancelled"] == 5
    assert got[3]["dropped_stale"] == 3 and got[3]["failed"] == 1
    assert got[3]["priority_jobs"] == 2 and got[3]["low_jobs"] == 3


def test_watchdog_fails_a_job_past_its_deadline():
    sched = tsched.DownloadScheduler(workers=1)
    gate = threading.Event()
    seen = []
    h = sched.submit("stuck", lambda: gate.wait(WAIT_S), lambda raw, dt: raw,
                     on_done=lambda r, handle: seen.append(handle.error),
                     deadline=0.1)
    t0 = time.monotonic()
    assert sched.drain(timeout=WAIT_S)          # the watchdog unwedges it
    assert time.monotonic() - t0 < WAIT_S / 2
    assert h.done() and isinstance(h.error, TimeoutError)
    assert sched.stats.timed_out == 1 and len(seen) == 1
    gate.set()                                  # the late work() is ignored
    time.sleep(0.05)
    assert sched.stats.completed == 0 and len(seen) == 1
    sched.shutdown(wait=True, timeout=WAIT_S)


def test_drain_waits_for_the_observers():
    sched = tsched.DownloadScheduler(workers=2)
    delivered = []

    def slow_observer(result, handle):
        time.sleep(0.05)
        delivered.append(result)

    for i in range(6):
        sched.submit(f"k{i}", lambda i=i: i, lambda raw, dt: raw, on_done=slow_observer)
    assert sched.drain(timeout=WAIT_S)
    assert sorted(delivered) == list(range(6)) and sched.outstanding() == 0
    sched.shutdown(wait=True, timeout=WAIT_S)
    assert sched.closed


def test_timed_out_shutdown_warns_with_the_undrained_count(caplog):
    gate, started = threading.Event(), threading.Event()

    def wedge():
        started.set()
        gate.wait(WAIT_S)

    sched = tsched.DownloadScheduler(workers=1, drain_timeout=0.2)
    sched.submit("wedged", wedge, lambda *a: None)
    assert started.wait(WAIT_S)                  # running: the flush can't cancel it
    with caplog.at_level(logging.WARNING, logger="repro_torch.core.scheduler"):
        t0 = time.monotonic()
        sched.shutdown(wait=True)
    assert time.monotonic() - t0 < WAIT_S / 2
    assert any("undrained" in r.message and "1" in r.message for r in caplog.records)
    gate.set()
    h = sched.submit("after", lambda: 1, lambda raw, dt: raw)
    assert h.done() and h.status == "cancelled"
