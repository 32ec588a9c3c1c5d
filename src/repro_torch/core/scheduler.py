"""Asynchronous PR-download scheduler.

The paper's dominant runtime cost is the partial-reconfiguration bitstream
download (~1.25 ms/region, §III).  Its analogue — the kernel build a
``BitstreamCache`` miss pays — is otherwise spent *synchronously on the
request's critical path*.  :class:`DownloadScheduler` turns that download
into a pipeline: the expensive work runs on background worker threads while
the caller keeps serving from a fallback (the traced function run eagerly,
or a prior-generation executable), and the finished bitstream is swapped in
atomically by a *commit* callback.

The scheduler is deliberately mechanism-only; policy lives in
:class:`~repro_torch.core.overlay.Overlay`:

* ``submit(key, work, commit, on_done)`` — enqueue one download.  ``work``
  runs on a worker thread (the kernel build; no shared state).  ``commit``
  runs afterwards, still on the worker, and must itself take the overlay
  lock and validate residency (``Fabric.is_current``) before publishing —
  the scheduler treats a ``None``/falsy commit result as *stale* and counts
  it dropped.  ``on_done`` observers receive the committed value (or None).
* three dispatch lanes: ``priority=True`` jumps the queue front (relocation
  rebinds), the default FIFO lane carries downloads, and ``low=True`` is the
  *background-optimization* lane (route specialization): a low job is only
  ever started when NOTHING is queued in the upper lanes, so a pending
  download or relocation is never delayed by a specialize compile.
* submissions **coalesce** by key: a second submit while the first is
  queued/running attaches its observer instead of downloading twice.
* ``cancel(key)`` — a queued job never runs; a running job loses its right
  to commit (marked stale).  ``flush()`` does this for every key — the
  reconfigure/evict path, so a late-arriving bitstream cannot resurrect an
  evicted resident.
* ``drain()`` — barrier: wait until nothing is queued or running (tests,
  benchmarks, deterministic shutdown).

Worker threads are daemonic and started lazily on first submit, so a
synchronous overlay never spawns a thread.

A copy of ``repro/core/scheduler.py`` (the port imports nothing of
``repro``); pure Python, so job order and statistics match the reference's
for the same submissions.  In the port the background work is a kernel
build (:func:`~repro_torch.core.interpreter.build_kernel`) or a CUDA-graph
capture (:class:`~repro_torch.core.interpreter.GraphKernel`), not an XLA
compile.
"""

from __future__ import annotations

import atexit
import collections
import dataclasses
import logging
import os
import threading
import time
import weakref
from typing import Any, Callable

__all__ = ["DownloadHandle", "DownloadScheduler", "SchedulerStats"]

logger = logging.getLogger(__name__)

# every live scheduler, so interpreter exit can wait out in-flight jobs:
# CPython kills daemon threads abruptly, and a worker killed inside a CUDA
# call (a graph capture) can take the whole process down with it
_LIVE_SCHEDULERS: "weakref.WeakSet[DownloadScheduler]" = weakref.WeakSet()


@atexit.register
def _shutdown_all_schedulers() -> None:   # pragma: no cover - exit hook
    for sched in list(_LIVE_SCHEDULERS):
        try:
            sched.shutdown(wait=True)
        except Exception:
            pass

# job lifecycle: QUEUED -> RUNNING -> DONE
#                   \-> CANCELLED  (dequeued before running)
#         RUNNING jobs hit by cancel/flush commit as stale -> DONE(dropped)
_QUEUED, _RUNNING, _DONE, _CANCELLED = "queued", "running", "done", "cancelled"


@dataclasses.dataclass
class SchedulerStats:
    submitted: int = 0        # jobs enqueued (first submit per key)
    coalesced: int = 0        # submits folded into an in-flight job
    completed: int = 0        # work() finished and commit accepted the result
    dropped_stale: int = 0    # work() finished but commit refused (flushed gen)
    cancelled: int = 0        # dequeued before running
    failed: int = 0           # work() raised
    priority_jobs: int = 0    # jobs that jumped the queue (relocation commits)
    low_jobs: int = 0         # background-lane jobs (route specialization)
    persist_jobs: int = 0     # store-persist jobs (always low lane)
    timed_out: int = 0        # jobs failed by the watchdog (deadline passed)
    download_seconds: float = 0.0   # total background work time


@dataclasses.dataclass
class DownloadHandle:
    """Observer handle for one submitted download."""

    key: str
    kind: str = "demand"
    _event: threading.Event = dataclasses.field(default_factory=threading.Event)
    result: Any = None        # committed value, or None (cancelled/stale/failed)
    error: BaseException | None = None
    status: str = _QUEUED
    seconds: float = 0.0      # measured background work time (the download)

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._event.wait(timeout)


class _Job:
    __slots__ = ("key", "work", "commit", "handles", "state", "stale",
                 "expires_at", "timed_out")

    def __init__(self, key: str, work: Callable[[], Any],
                 commit: Callable[[Any, float], Any]) -> None:
        self.key = key
        self.work = work
        self.commit = commit
        self.handles: list[
            tuple[DownloadHandle,
                  "Callable[[Any, DownloadHandle], None] | None"]] = []
        self.state = _QUEUED
        self.stale = False     # cancel()/flush() hit it while running
        self.expires_at: float | None = None   # monotonic watchdog deadline
        self.timed_out = False  # watchdog already failed + delivered it


class DownloadScheduler:
    """Background pipeline for PR-bitstream downloads (place+compile)."""

    def __init__(self, workers: int = 1, name: str = "pr-download",
                 idle_timeout: float = 30.0,
                 drain_timeout: float = 30.0) -> None:
        if workers < 1:
            raise ValueError("workers must be >= 1")
        self.workers = workers
        self.name = name
        self.idle_timeout = idle_timeout      # idle workers expire (no leak
        self.drain_timeout = drain_timeout    # from abandoned overlays)
        self.stats = SchedulerStats()
        self._cond = threading.Condition()
        self._queue: collections.deque[_Job] = collections.deque()
        self._low: collections.deque[_Job] = collections.deque()   # spec lane
        self._jobs: dict[str, _Job] = {}      # queued or running, by key
        self._finishing = 0                   # jobs delivering observer calls
        self._threads: list[threading.Thread] = []
        self._watchdog: threading.Thread | None = None
        self._shutdown = False
        _LIVE_SCHEDULERS.add(self)

    # -- submission -----------------------------------------------------------
    def submit(self, key: str, work: Callable[[], Any],
               commit: Callable[[Any, float], Any], *,
               on_done: "Callable[[Any, DownloadHandle], None] | None" = None,
               kind: str = "demand", priority: bool = False,
               low: bool = False,
               deadline: float | None = None) -> DownloadHandle:
        """Enqueue ``work`` (worker thread) followed by ``commit`` (same
        thread; must validate + publish).  Same-key submits while the first
        is in flight coalesce onto it.  ``on_done`` observers are invoked as
        ``on_done(result, handle)`` — the handle carries error/timing, so an
        observer can distinguish a failed download from a stale one.

        ``priority=True`` puts the job at the *front* of the queue — for
        cheap generation-guarded relocation commits (re-emit routes, rebind
        the cached kernel) that must never wait behind a full kernel build.
        ``low=True`` routes the job to the background-optimization lane:
        workers only pick it up while the main queue is EMPTY, so a pending
        download/relocation is never delayed by it (route specialization).

        ``deadline`` (seconds from now) arms the watchdog: a job still
        outstanding past its deadline is failed with :class:`TimeoutError`
        delivered to its observers instead of wedging ``drain()``.

        Submitting against a shut-down scheduler returns an already-done
        CANCELLED handle (observers still fire, with ``result=None``) —
        callers pre-check ``closed`` lock-free, so ``close()`` racing a
        dispatch must degrade to "download never happened", not an
        exception on the dispatching thread."""
        if priority and low:
            raise ValueError("a job cannot be both priority and low")
        handle = DownloadHandle(key=key, kind=kind)
        rejected = False
        with self._cond:
            if self._shutdown:
                # shutdown-race fix: callers pre-check ``closed`` lock-free,
                # so ``close()`` can land between the check and the submit.
                # That race is benign — answer with an already-cancelled
                # handle (exactly what submit-then-flush would yield)
                # instead of blowing up the submitting dispatch thread.
                handle.status = _CANCELLED
                handle._event.set()
                self.stats.cancelled += 1
                rejected = True
            else:
                job = self._jobs.get(key)
                if job is not None and not job.stale:
                    job.handles.append((handle, on_done))
                    handle.status = job.state
                    self.stats.coalesced += 1
                    if deadline is not None:
                        expires = time.monotonic() + deadline
                        if job.expires_at is None or expires < job.expires_at:
                            job.expires_at = expires
                        self._ensure_watchdog()
                    return handle
                job = _Job(key, work, commit)
                job.handles.append((handle, on_done))
                if deadline is not None:
                    job.expires_at = time.monotonic() + deadline
                    self._ensure_watchdog()
                self._jobs[key] = job
                if priority:
                    self._queue.appendleft(job)
                    self.stats.priority_jobs += 1
                elif low:
                    self._low.append(job)
                    self.stats.low_jobs += 1
                else:
                    self._queue.append(job)
                if kind == "persist":
                    self.stats.persist_jobs += 1
                self.stats.submitted += 1
                self._ensure_workers()
                self._cond.notify()
        if rejected and on_done is not None:
            # observers run outside the scheduler lock (``_finish`` contract)
            on_done(None, handle)
        return handle

    def _ensure_workers(self) -> None:
        # called under the lock; lazily grow to the configured worker count
        self._threads = [t for t in self._threads if t.is_alive()]
        while len(self._threads) < self.workers:
            t = threading.Thread(target=self._worker_loop,
                                 name=f"{self.name}-{len(self._threads)}",
                                 daemon=True)
            self._threads.append(t)
            t.start()

    def _ensure_watchdog(self) -> None:
        # called under the lock; lazily spawned only once a deadlined job
        # exists, so deadline-free schedulers never pay a watchdog thread
        if self._watchdog is None or not self._watchdog.is_alive():
            self._watchdog = threading.Thread(target=self._watchdog_loop,
                                              name=f"{self.name}-watchdog",
                                              daemon=True)
            self._watchdog.start()

    def _watchdog_loop(self) -> None:
        """Fail jobs (queued OR running) whose deadline has passed: the
        handle gets a :class:`TimeoutError`, the job stops counting as
        outstanding (so ``drain()`` unwedges), and a running job forfeits
        its commit via the stale flag."""
        while True:
            expired: list[_Job] = []
            with self._cond:
                now = time.monotonic()
                next_at: float | None = None
                for job in list(self._jobs.values()):
                    if job.expires_at is None:
                        continue
                    if job.expires_at <= now:
                        job.stale = True        # a late work() may not commit
                        job.timed_out = True
                        if job.state == _QUEUED:
                            for lane in (self._queue, self._low):
                                try:
                                    lane.remove(job)
                                    break
                                except ValueError:
                                    pass
                        job.state = _DONE
                        del self._jobs[job.key]
                        self.stats.timed_out += 1
                        self._finishing += 1
                        expired.append(job)
                    elif next_at is None or job.expires_at < next_at:
                        next_at = job.expires_at
                if not expired:
                    if next_at is None:
                        # nothing deadlined left: retire (submit respawns)
                        self._watchdog = None
                        return
                    self._cond.wait(min(0.5, max(0.001, next_at - now)))
                    continue
            for job in expired:
                err = TimeoutError(f"download {job.key!r} exceeded its "
                                   f"deadline; failed by watchdog")
                self._finish(job, None, _DONE, err)
            with self._cond:
                self._finishing -= len(expired)
                self._cond.notify_all()

    # -- cancellation ---------------------------------------------------------
    def cancel(self, key: str) -> bool:
        """Stop ``key``'s download: unqueue it, or strip a running job of its
        right to commit.  Returns True if a job was affected."""
        finished: _Job | None = None
        with self._cond:
            job = self._jobs.get(key)
            if job is None:
                return False
            job.stale = True
            if job.state == _QUEUED:
                dequeued = False
                for lane in (self._queue, self._low):
                    try:
                        lane.remove(job)
                        dequeued = True
                        break
                    except ValueError:  # pragma: no cover - already popped
                        pass
                if dequeued:
                    job.state = _CANCELLED
                    del self._jobs[key]
                    self.stats.cancelled += 1
                    self._finishing += 1
                    finished = job
        if finished is not None:
            try:
                self._finish(finished, None, _CANCELLED)
            finally:
                with self._cond:
                    self._finishing -= 1
                    self._cond.notify_all()
        return True

    def flush(self) -> int:
        """Cancel every queued download and mark every running one stale —
        the full-fabric reconfigure path.  Returns jobs affected."""
        with self._cond:
            keys = list(self._jobs)
        return sum(1 for k in keys if self.cancel(k))

    # -- synchronization ------------------------------------------------------
    @property
    def closed(self) -> bool:
        return self._shutdown

    def outstanding(self) -> int:
        with self._cond:
            return len(self._jobs)

    def drain(self, timeout: float | None = None) -> bool:
        """Block until no download is queued, running, or mid-delivery —
        when this returns True every observer (swap) callback has run."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._jobs or self._finishing:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                self._cond.wait(remaining if remaining is not None else 0.5)
            return True

    def shutdown(self, *, wait: bool = True,
                 timeout: float | None = None) -> None:
        """Flush, optionally drain (``timeout`` overrides the constructor's
        ``drain_timeout``), then refuse new work.  A timed-out drain warns
        with the undrained job count instead of returning silently."""
        self.flush()
        if wait:
            limit = self.drain_timeout if timeout is None else timeout
            if not self.drain(timeout=limit):
                logger.warning(
                    "scheduler %r: drain timed out after %.1fs with %d "
                    "undrained job(s); shutting down anyway",
                    self.name, limit, self.outstanding())
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()

    # -- worker ---------------------------------------------------------------
    def _worker_loop(self) -> None:
        try:
            # background QoS: a bitstream compile must not steal CPU from
            # the request being served by the fallback (Linux allows
            # per-thread niceness through PRIO_PROCESS + native thread id)
            os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 10)
        except (AttributeError, OSError):        # pragma: no cover - platform
            pass
        while True:
            with self._cond:
                deadline = time.monotonic() + self.idle_timeout
                while not self._queue and not self._low and not self._shutdown:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        # idle expiry: abandoned overlays must not pin a
                        # thread forever; submit() respawns on demand
                        try:
                            self._threads.remove(threading.current_thread())
                        except ValueError:   # pragma: no cover
                            pass
                        return
                    self._cond.wait(remaining)
                if self._shutdown and not self._queue and not self._low:
                    return
                # strict lane order: the low (specialization) lane is only
                # drained while NO download/relocation is waiting
                job = (self._queue.popleft() if self._queue
                       else self._low.popleft())
                job.state = _RUNNING
                for handle, _ in job.handles:
                    handle.status = _RUNNING
            self._run_job(job)

    def _run_job(self, job: _Job) -> None:
        result, error = None, None
        t0 = time.perf_counter()
        try:
            raw = job.work()
            # commit validates (overlay lock + Fabric.is_current) and
            # publishes; a stale job forfeits its commit entirely
            result = None if job.stale else job.commit(raw, time.perf_counter() - t0)
        except BaseException as exc:   # noqa: BLE001 - reported via handle
            error = exc
        dt = time.perf_counter() - t0
        with self._cond:
            self.stats.download_seconds += dt
            if job.timed_out:
                # the watchdog already failed this job and delivered
                # TimeoutError to its observers; a late work() completion
                # must neither re-deliver nor double-count
                return
            for handle, _ in job.handles:
                handle.seconds = dt
            if error is not None:
                self.stats.failed += 1
            elif result is None:
                self.stats.dropped_stale += 1
            else:
                self.stats.completed += 1
            job.state = _DONE
            if self._jobs.get(job.key) is job:
                del self._jobs[job.key]
            # the job is no longer "outstanding" but its observers haven't
            # run: keep drain() blocked until _finish delivers the swap
            self._finishing += 1
        try:
            self._finish(job, result, _DONE, error)
        finally:
            with self._cond:
                self._finishing -= 1
                self._cond.notify_all()

    def _finish(self, job: _Job, result: Any, status: str,
                error: BaseException | None = None) -> None:
        # runs OUTSIDE the scheduler lock: observers may take the overlay
        # lock, which foreground threads hold while calling cancel()/flush()
        for handle, on_done in job.handles:
            handle.result = result
            handle.error = error
            handle.status = status
            handle._event.set()
            if on_done is not None:
                try:
                    on_done(result, handle)
                except Exception:       # pragma: no cover - observer bug
                    pass

    def describe(self) -> dict[str, Any]:
        with self._cond:
            return {"outstanding": len(self._jobs),
                    "workers": len([t for t in self._threads if t.is_alive()]),
                    **dataclasses.asdict(self.stats)}
