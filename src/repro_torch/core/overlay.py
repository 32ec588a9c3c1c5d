"""Overlay facade — the dynamic overlay the paper's runtime exposes.

The primary programming model is the *trace-based frontend* (the paper's
pitch: ordinary source code, no hardware programming model)::

    overlay = Overlay(rows=3, cols=3)              # build the fabric

    @overlay.jit                                   # or: acc = overlay.jit(fn)
    def dot(a, b):
        return torch.sum(a * b)

    y = dot(a, b)                                  # trace -> place -> assemble
                                                   # -> cached bitstream -> run

``overlay.jit`` captures the function at the aten level (``trace.py``),
lowers supported ops onto the operator library, builds a :class:`Graph` as
IR, and feeds it through placement / ISA / assembly.  Unmapped ops stay as
residue unless ``strict=True``.

Also provided, mirroring the paper's runtime controls:

* ``Overlay.aot(fn, *args)``  — ahead-of-time bitstream-cache population
  (pay the "PR download" before traffic arrives),
* ``Overlay(async_downloads=True)`` — the asynchronous PR-download
  pipeline: a miss is served at once by a fallback (the traced function run
  eagerly, the paper's software fallback while the bitstream downloads, or
  the prior generation's accelerator) while the kernel builds on a
  :class:`~repro_torch.core.scheduler.DownloadScheduler` worker and swaps
  in; ``jitted.prefetch(*args)`` starts a download ahead of demand,
* the failure model — ``faults=FaultPlan(...)`` injects download,
  dispatch and resident-loss faults; a failed download retries on a
  deterministic backoff clock behind a per-entry circuit breaker, a failed
  dispatch evicts the suspect resident and serves the call from the
  fallback, and :meth:`Overlay.failure_ledger` counts it all,
* ``Overlay.reconfigure()``   — flush the fabric: placements + bitstreams
  (``relocate=True`` moves residents instead — kernels survive),
* ``Overlay.evict(name)``     — free one accelerator's PR regions,
* ``Overlay.defragment()`` / ``Overlay.relocate(graph, placement)`` /
  ``Overlay.repack(rid, budget)`` — move residents between placements
  *without* re-downloading: kernels are placement-free, only the route
  program is re-emitted,
* tiered route specialization — ``jitted.specialize(*args)`` builds the
  route-constant tier for a resident (on the card: the walk captured once
  as a CUDA graph, replayed on every dispatch) and swaps the dispatch
  record onto it; on an asynchronous overlay the build rides the
  scheduler's low lane; any relocation instantly despecializes back to the
  generic kernel,
* ``Overlay(cost_model_placement=True)`` — candidate placements scored in
  seconds-equivalent cost instead of first-fit, and priced reclaims,
* ``Overlay(store_path=dir)`` — the persistent bitstream store: built
  kernels are written to disk on the scheduler's low lane (the kernel's
  serial form, :class:`~repro_torch.core.store.BitstreamStore`), a later
  process pointed at the same directory loads them instead of building,
  and the measurement ledger the planner prices with survives restarts,
* the sanitizer — ``Overlay(sanitize=True)`` or ``REPRO_SANITIZE=1`` runs
  :mod:`repro_torch.analysis.check` at every mutation edge (admit, evict,
  relocate, specialization commit, flush) and raises
  :class:`~repro_torch.analysis.check.InvariantError` on the first
  violation; off, it adds no work,
* ``Overlay.jit(fn, donate_argnums=(0,))`` — buffer donation: the kernel
  writes each output into the storage of a donated input of its shape and
  dtype and returns that input (a traced train step then holds one copy of
  its state); donated and undonated kernels of one function have distinct
  cache and store keys,
* ``Overlay.assemble(graph)`` — the low-level IR path (hand-built Graphs),
  idempotent and cached.

All accelerators of one overlay co-reside on one :class:`Fabric`; an
admission that does not fit reclaims least-recently-used residents.  A
resident hit dispatches through an immutable per-entry dispatch record that
one generation read validates, without the overlay lock; every fabric and
cache mutation, foreground or a worker's commit, holds it.

Port of ``repro/core/overlay.py``.  Where the reference queues work on its
scheduler on a synchronous overlay too (an auto-specialization, a rebind
after a relocation), the port does it inline there and queues it only on an
asynchronous overlay; persists ride the low lane on both, as in the
reference.  The trace stays on the caller, as in the reference: the
asynchronous pipeline hides the assembly, and the store the kernel build,
not the trace.  ``Overlay(mesh=, tile_axis=)`` assembles across devices,
as the reference: every tile is a rank of that ``DeviceMesh`` axis and
every hop a ring shift over ``torch.distributed``
(:func:`~repro_torch.core.interpreter.assemble_sharded`).  Each rank runs
the overlay SPMD on the same calls.  A mesh forces the synchronous mode
and skips the store, whose kernels name no process group.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
import warnings
import weakref
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro_torch.core import cache as cache_lib
from repro_torch.core import interpreter as interp
from repro_torch.core import trace as trace_lib
from repro_torch.core.cache import BitstreamCache
from repro_torch.core.fabric import Fabric, FabricError, ResidentAccelerator
from repro_torch.core.faults import FaultError, FaultPlan
from repro_torch.core.graph import Graph
from repro_torch.core.isa import Program, compile_graph
from repro_torch.core.placement import (Coord, Placement, PlacementError,
                                        PlacementPolicy, TileGrid,
                                        candidate_placements, check_assignment,
                                        place, score_placement)
from repro_torch.core.scheduler import DownloadHandle, DownloadScheduler
from repro_torch.core.store import BitstreamStore
from repro_torch.core.trace import SerialError
from repro_torch.serving.metrics import Histogram

logger = logging.getLogger(__name__)

# a persistently failing download opens its breaker after this many attempts
# (the default breaker_threshold), and a resident whose specialization keeps
# failing stops being retried at its routes after as many (the cap resets on
# relocation)
_MAX_DOWNLOAD_FAILURES = 3

@dataclasses.dataclass
class OverlayStats:
    assemblies: int = 0
    reconfigurations: int = 0   # placements changed between assemblies
    traces: int = 0             # frontend captures (jit/aot signatures)
    trace_seconds: float = 0.0  # total trace+lowering time (frontend cost)
    downloads: int = 0          # accelerators placed + admitted to the fabric
    evictions: int = 0          # residents released (explicit or reclaimed)
    reclaims: int = 0           # evictions forced by placement pressure
    defrags: int = 0            # defragmentation passes that moved residents
    relocations: int = 0        # residents moved WITHOUT re-downloading
    defrag_failures: int = 0    # defrag passes aborted by an unplaceable survivor
    prefetches: int = 0         # downloads begun on a hint, not a demand
    prefetch_hits: int = 0      # demand requests satisfied by a prior prefetch
    fallback_calls: int = 0     # calls served by a fallback mid-download
    stale_downloads: int = 0    # background results dropped (generation flushed)
    download_failures: int = 0  # download attempts that raised
    download_retries: int = 0   # re-attempts after a backoff window elapsed
    breaker_opens: int = 0      # entries pinned to fallback (failure cap hit)
    breaker_probes: int = 0     # probe downloads while a breaker was open
    breaker_closes: int = 0     # breakers re-closed by a successful probe
    dispatch_failures: int = 0  # resident dispatches that raised
    dispatch_fallbacks: int = 0 # failed dispatches served by the fallback
    resident_losses: int = 0    # residents lost at dispatch time (injected)


@dataclasses.dataclass(frozen=True)
class _DispatchRecord:
    """Immutable snapshot the dispatch fast path runs on, validated per call
    by ONE liveness + generation read against its resident: any residency
    change (evict, reclaim, relocate, reconfigure) kills or bumps the
    generation, so a stale record fails closed into the slow path, which
    rebuilds it."""

    fn: Callable[..., Any]               # routes-bound artifact of `tier`
    res: ResidentAccelerator
    generation: int
    tier: str                            # "generic" | "specialized"


@dataclasses.dataclass
class _JitEntry:
    """One (signature, static-args) instantiation of a jitted function."""

    lowered: trace_lib.Lowered
    acc: interp.AssembledAccelerator | None   # None: traced but not assembled
    trace_seconds: float            # capture + aten->Graph lowering
    assemble_seconds: float = 0.0   # placement + ISA compile + kernel build
    closed: Callable[..., Any] | None = None  # traced closure (eager fallback)
    pending: DownloadHandle | None = None     # in-flight background download
    download_failures: int = 0                # consecutive failed downloads
    record: _DispatchRecord | None = None
    # donation: {"donate_argnums": flat leaf indices} (the kernel key
    # includes it) and the (output, input) leaf pairs a fallback lands
    jit_kwargs: dict[str, Any] | None = None
    aliases: tuple = ()
    # deterministic retry/backoff clock: `calls` ticks once per slow-path
    # call and every retry decision keys on it, never on wall-clock, so a
    # failure schedule replays exactly.  The breaker pins a repeatedly
    # failing entry to its fallback; while "open" only probe downloads
    # (every `probe_interval` calls, doubling per failed probe) are
    # attempted, and one success re-closes it.
    calls: int = 0
    retry_at: int = 0
    breaker: str = "closed"                   # "closed" | "open"
    breaker_opened_at: int = 0
    probe_interval: int = 0


@dataclasses.dataclass(frozen=True)
class _PendingDownload:
    """What a background download builds from, and what its commit checks
    to publish the kernel or recognize it went stale."""

    rid: str
    generation: int
    key: str
    graph: Graph
    jit_kwargs: dict[str, Any] | None = None   # the key includes these, so
                                               # the kernel must honor them


@dataclasses.dataclass(frozen=True)
class _PendingSpecialize:
    """What a specialization is built from.  Unlike a download (a
    ``same_residency`` guard — kernels are placement-free), its commit
    validates the EXACT generation: the baked hop constants describe one
    placement, so a relocation in flight makes the build useless."""

    rid: str
    generation: int                    # exact — relocation invalidates
    key: str                           # generic kernel key being specialized
    spec_key: str                      # key + baked hop vector
    graph: Graph
    hops: tuple
    inputs: tuple                      # example leaves (tensor or None)
    jit_kwargs: dict[str, Any] | None = None


class JitAssembled:
    """Callable wrapper returned by :meth:`Overlay.jit`.

    Per input signature (flat shapes/dtypes/devices + static argument
    values) the wrapper traces once, assembles once, then dispatches
    straight to the cached accelerator.  Pytree arguments/results are
    supported; the graph sees one input per flat leaf.  The leaves of the
    ``donate_argnums`` arguments are donated: an output lands in the
    storage of a donated leaf of its shape and dtype, on every path that
    serves a call (the kernel walk, its CUDA graph, the eager fallback).
    A dispatch that fails before its walk has written anything is served
    from the fallback.
    """

    def __init__(self, overlay: "Overlay", fn: Callable[..., Any], *,
                 strict: bool = False, name: str | None = None,
                 fixed: dict[int, Coord] | None = None,
                 static_argnums: tuple[int, ...] = (),
                 donate_argnums: tuple[int, ...] = (),
                 tile_budget: int | None = None) -> None:
        self.overlay = overlay
        self.fn = fn
        self.strict = strict
        self.name = name or getattr(fn, "__name__", None) or "jit"
        self.fixed = fixed
        self.static_argnums = tuple(static_argnums)
        self.donate_argnums = tuple(donate_argnums)
        overlap = set(self.static_argnums) & set(self.donate_argnums)
        if overlap:
            raise ValueError(f"arguments {sorted(overlap)} are both static and donated")
        self.tile_budget = tile_budget
        self._entries: dict[Any, _JitEntry] = {}
        self.__name__ = self.name
        self.__doc__ = getattr(fn, "__doc__", None)
        overlay._wrappers.add(self)

    # -- signature handling ---------------------------------------------------
    @staticmethod
    def _sig_key(dyn: tuple, static_repr: str):
        """The entry-table key: flat abstract signature + pytree structure +
        static-argument values.  A hashable tuple: this runs per call."""
        leaves, treedef = pytree.tree_flatten(dyn)
        return (tuple(cache_lib.leaf_signature(a) for a in leaves),
                treedef, static_repr)

    def _split(self, args: tuple):
        """Split positional args into (dynamic args, closed fn, static repr)."""
        if not self.static_argnums:
            return args, self.fn, ""
        static = {i: args[i] for i in self.static_argnums if i < len(args)}
        dyn = tuple(a for i, a in enumerate(args) if i not in static)

        def closed(*dyn_args, _static=static, _n=len(args)):
            it = iter(dyn_args)
            full = [_static[i] if i in _static else next(it) for i in range(_n)]
            return self.fn(*full)

        closed.__name__ = self.name
        return dyn, closed, repr(sorted(static.items()))

    def _donate_leaf_indices(self, args: tuple) -> tuple[int, ...]:
        """The user-level ``donate_argnums`` as flat-leaf indices of the
        dynamic arguments (the graph's input positions)."""
        if not self.donate_argnums:
            return ()
        out, offset = [], 0
        for i, a in enumerate(args):
            if i in self.static_argnums:
                continue
            n = len(pytree.tree_leaves(a))
            if i in self.donate_argnums:
                out.extend(range(offset, offset + n))
            offset += n
        return tuple(out)

    def _jit_kwargs(self, args: tuple) -> dict[str, Any] | None:
        donate = self._donate_leaf_indices(args)
        return {"donate_argnums": donate} if donate else None

    def _traced(self, key, closed: Callable[..., Any], dyn: tuple,
                args: tuple) -> _JitEntry:
        """The (possibly assembly-less) entry for a signature, tracing at
        most once: ``lower()`` and ``__call__`` share the memo."""
        entry = self._entries.get(key)
        if entry is None:
            t0 = time.perf_counter()
            lowered = trace_lib.trace_to_graph(closed, *dyn, name=self.name,
                                               strict=self.strict)
            dt = time.perf_counter() - t0
            self.overlay.stats.traces += 1
            self.overlay.stats.trace_seconds += dt
            jit_kwargs = self._jit_kwargs(args)
            entry = _JitEntry(lowered=lowered, acc=None, trace_seconds=dt,
                              closed=closed, jit_kwargs=jit_kwargs)
            if jit_kwargs:
                entry.aliases = interp.donation_aliases(
                    lowered.graph, jit_kwargs["donate_argnums"])
            self._entries[key] = entry
        return entry

    @staticmethod
    def _land(entry: _JitEntry, dyn: tuple, out: Any) -> Any:
        """A fallback's answer, with each aliased output landed in its
        donated input leaf (the kernel walk does this as it goes)."""
        if not entry.aliases:
            return out
        ins = pytree.tree_leaves(dyn)
        outs, spec = pytree.tree_flatten(out)
        for o, i in interp.donation_targets(tuple(ins), entry.aliases):
            outs[o] = interp.write_back(ins[i], outs[o])
        return pytree.tree_unflatten(outs, spec)

    def _swap(self, entry: _JitEntry, acc, t0: float,
              handle: DownloadHandle | None) -> None:
        """Background-download completion: publish the assembled
        accelerator (``acc is None``: download cancelled, stale or failed —
        clear the pending marker so the next call asks again)."""
        if handle is not None and entry.pending is not None \
                and entry.pending is not handle:
            # a superseded job's late delivery (the pre-reconfigure
            # download, flushed and replaced): the live download owns the
            # entry
            return
        if acc is not None:
            entry.acc = acc
            # the handle's measured worker time is the download cost; the
            # submit->delivery wall clock would also bill queue wait
            entry.assemble_seconds = (handle.seconds if handle is not None
                                      and handle.seconds > 0.0
                                      else time.perf_counter() - t0)
            self._note_download_success(entry)
            self.overlay._publish_record(entry)
        elif handle is not None and handle.error is not None:
            self._note_download_failure(entry, handle.error)
        entry.pending = None

    # -- retry / circuit breaker ----------------------------------------------
    def _download_allowed(self, entry: _JitEntry) -> bool:
        """Whether an attempt may start NOW, per the entry's deterministic
        retry clock.  Closed breaker: allowed once the exponential-backoff
        window (in slow-path calls, not seconds) has elapsed.  Open
        breaker: only a probe every ``probe_interval`` calls."""
        ov = self.overlay
        if entry.breaker == "open":
            if entry.calls - entry.breaker_opened_at < entry.probe_interval:
                return False
            entry.breaker_opened_at = entry.calls
            ov.stats.breaker_probes += 1
            return True
        if entry.download_failures and entry.calls < entry.retry_at:
            return False
        if entry.download_failures:
            ov.stats.download_retries += 1
        return True

    def _note_download_failure(self, entry: _JitEntry,
                               error: BaseException) -> None:
        """Book one failed download attempt: schedule the deterministic
        backoff, open the breaker at the threshold, double the probe window
        on a failed probe.  The fallback keeps serving throughout."""
        ov = self.overlay
        entry.download_failures += 1
        ov.stats.download_failures += 1
        if entry.breaker == "open":
            entry.probe_interval = min(256, max(1, entry.probe_interval * 2))
            entry.breaker_opened_at = entry.calls
            return
        if entry.download_failures >= ov.breaker_threshold:
            entry.breaker = "open"
            entry.breaker_opened_at = entry.calls
            entry.probe_interval = ov.breaker_probe_after
            ov.stats.breaker_opens += 1
            warnings.warn(
                f"PR downloads for {self.name!r} failed "
                f"{entry.download_failures} times ({error!r}); breaker "
                f"open — pinned to the fallback, probing every "
                f"{entry.probe_interval} calls.",
                RuntimeWarning, stacklevel=2)
        else:
            entry.retry_at = entry.calls + ov.retry_backoff * (
                2 ** (entry.download_failures - 1))
            if entry.download_failures == 1:
                warnings.warn(
                    f"background PR download for {self.name!r} failed "
                    f"({error!r}); serving from the fallback and retrying "
                    f"with backoff.",
                    RuntimeWarning, stacklevel=2)

    def _note_download_success(self, entry: _JitEntry) -> None:
        if entry.breaker == "open":
            entry.breaker = "closed"
            self.overlay.stats.breaker_closes += 1
        entry.download_failures = 0
        entry.retry_at = 0

    def _submit(self, entry: _JitEntry, *, kind: str = "demand",
                reclaim: bool = True, low: bool = False
                ) -> DownloadHandle | None:
        """Request this entry's download under the backoff clock and the
        breaker (the fallback serves either way).  After
        ``overlay.close()`` no download starts, and calls are still
        served."""
        if self.overlay.scheduler.closed or not self._download_allowed(entry):
            return None
        t0 = time.perf_counter()
        # clear first: a cached kernel completes inline, delivering on_done
        # before submit_download returns, and _swap must not mistake the
        # previous outage's done handle for a live download
        entry.pending = None
        handle = self.overlay.submit_download(
            entry.lowered.graph, fixed=self.fixed, tile_budget=self.tile_budget,
            jit_kwargs=entry.jit_kwargs, kind=kind, reclaim=reclaim, low=low,
            on_done=lambda acc, h: self._swap(entry, acc, t0, h))
        entry.pending = handle
        return handle

    def _entry(self, args: tuple, *, aot: bool = False,
               _presplit=None) -> _JitEntry:
        dyn, closed, static_repr = _presplit or self._split(args)
        entry = self._traced(self._sig_key(dyn, static_repr), closed, dyn, args)
        ov = self.overlay
        acc = entry.acc
        if acc is not None and ov.resident_current(acc):
            if not ov.repack(acc.resident_id, self.tile_budget):
                # still resident in the fabric: bump recency
                ov.fabric.touch(acc.resident_id)
                ov._note_demand(acc.resident_id)
                return entry
            # the budget changed and the resident relocated: fall through,
            # the (cheap) re-assembly rebinds the entry to its routes
        # first assembly for this signature, or the accelerator was
        # reclaimed / flushed since: re-place and re-download
        if aot or not ov.async_downloads:
            if not self._download_allowed(entry):
                return entry               # backing off / breaker open
            t0 = time.perf_counter()
            try:
                entry.acc = ov.assemble(entry.lowered.graph, fixed=self.fixed,
                                        tile_budget=self.tile_budget,
                                        jit_kwargs=entry.jit_kwargs)
            except (PlacementError, FabricError):
                raise                      # structural — must propagate
            except Exception as exc:
                if self.overlay.sanitize:
                    from repro_torch.analysis.check import InvariantError
                    if isinstance(exc, InvariantError):
                        raise              # a sanitizer verdict is a bug, not
                                           # an outage: never degrade it
                # a failed download (injected or real): serve from the
                # fallback and retry later on the backoff clock
                self._note_download_failure(entry, exc)
                entry.pending = None
                return entry
            entry.assemble_seconds = time.perf_counter() - t0
            entry.pending = None
            self._note_download_success(entry)
            ov._publish_record(entry)
            return entry
        # asynchronous pipeline: the fallback serves.  ``__call__`` requests
        # the download only AFTER the response is computed (and
        # :meth:`prefetch` ahead of demand), so a request never contends
        # with its own download for the interpreter lock.
        return entry

    def _ensure_download(self, entry: _JitEntry) -> None:
        """Request the background download once per outage; the scheduler
        coalesces repeats by residency key."""
        if not self.overlay.async_downloads:
            return          # a synchronous overlay retries through _entry
        if entry.pending is not None and not entry.pending.done():
            # demanded while in flight: keep the resident's recency honest
            # (handle.key IS the rid), so a hot accelerator does not look
            # like the LRU victim before its bitstream lands
            self.overlay.fabric.touch(entry.pending.key)
            return
        self._submit(entry)

    # -- public surface -------------------------------------------------------
    def lower(self, *args) -> trace_lib.Lowered:
        """The lowered IR for this signature (traced at most once)."""
        dyn, closed, static_repr = self._split(args)
        return self._traced(self._sig_key(dyn, static_repr), closed, dyn, args).lowered

    def accelerator(self, *args) -> interp.AssembledAccelerator | None:
        """The assembled accelerator for this signature (traces if needed;
        None on an asynchronous overlay until its download lands)."""
        return self._entry(args).acc

    def timings(self, *args) -> dict[str, float]:
        """Frontend vs backend split for this signature."""
        e = self._entry(args)
        return {"trace_seconds": e.trace_seconds,
                "assemble_seconds": e.assemble_seconds}

    def prefetch(self, *args, low: bool = False,
                 reclaim: bool = True) -> DownloadHandle | None:
        """Hint: download this signature's bitstream before traffic needs
        it.  ``args`` may be concrete tensors or :class:`TensorSpec`
        pytrees.  On an asynchronous overlay the kernel builds on the
        scheduler's worker (returns the in-flight handle; ``low=True``
        rides the low lane, ``reclaim=False`` raises
        :class:`PlacementError` under pressure instead of displacing
        residents); on a synchronous overlay the download is paid here (AOT
        population).  An already-resident signature is a no-op."""
        presplit = self._split(args)
        dyn, closed, static_repr = presplit
        entry = self._traced(self._sig_key(dyn, static_repr), closed, dyn, args)
        ov = self.overlay
        acc = entry.acc
        if acc is not None and ov.resident_current(acc):
            return None
        if not ov.async_downloads:
            self._entry(args, aot=True, _presplit=presplit)
            ov.stats.prefetches += 1
            if entry.acc is not None:     # the download may have failed
                ov._prefetched.add(entry.acc.resident_id)
            return None
        if entry.pending is not None and not entry.pending.done():
            return entry.pending
        return self._submit(entry, kind="prefetch", reclaim=reclaim, low=low)

    def _prefetch_known(self) -> int:
        """Re-request downloads for every signature this wrapper has seen —
        the warm-up after ``reconfigure()`` (the flush dropped every
        resident; the traced graphs are still in the entry table)."""
        ov = self.overlay
        n = 0
        for entry in list(self._entries.values()):
            acc = entry.acc
            if acc is not None and ov.resident_current(acc):
                continue
            if not ov.fabric.free():
                break            # fabric full: a warm-up must not reclaim
            try:                 # through just-prefetched residents
                submitted = self._submit(entry, kind="prefetch", reclaim=False)
            except PlacementError:
                break
            if submitted is not None:
                n += 1
        return n

    def specialize(self, *args) -> DownloadHandle | None:
        """Build the route-constant *specialized* tier for this signature
        and swap the dispatch record onto it.  ``args`` may be concrete
        tensors (the warm-up and capture read them) or :class:`TensorSpec`
        pytrees (zeros of those shapes are used).  Admits/downloads the
        generic tier first if needed; a no-op when the resident is already
        specialized.  On the card the tier is the walk captured as a CUDA
        graph.  On an asynchronous overlay the build is queued on the
        scheduler's LOW lane (it never delays a download or relocation) and
        its handle returned; a failed build there is counted and the
        generic tier keeps serving.  On a synchronous overlay it is paid
        here, and a failure raises.  A later relocation instantly
        despecializes back to the generic kernel."""
        ov = self.overlay
        presplit = self._split(args)
        dyn, closed, static_repr = presplit
        entry = self._traced(self._sig_key(dyn, static_repr), closed, dyn, args)
        acc = entry.acc
        if acc is None or not ov.resident_current(acc):
            if ov.async_downloads:
                self.prefetch(*args)       # admit + download the generic first
            else:
                self._entry(args, aot=True, _presplit=presplit)
        graph = entry.lowered.graph
        res = ov.fabric.get(ov._resident_key(graph, graph.input_avals(), self.fixed))
        if res is None or res.tier != "generic" or res.spec_pending:
            return None
        leaves = tuple(x if isinstance(x, torch.Tensor) else None
                       for x in pytree.tree_leaves(dyn))
        if ov.async_downloads and not ov.scheduler.closed:
            with ov._lock:
                return ov._submit_specialize_locked(entry, res, leaves)
        ov._specialize_now(entry, res, leaves)
        return None

    def __call__(self, *args):
        return self._invoke(args)[0]

    def _invoke(self, args: tuple, writeback: bool = True) -> tuple[Any, bool]:
        """Serve one call: ``(outputs, whether a resident dispatch failed
        and the fallback answered)``.  ``writeback=False`` leaves the
        donated inputs of a failed dispatch untouched, so a fleet can retry
        the call on another copy from the same state."""
        presplit = self._split(args)
        entry = self._entries.get(self._sig_key(presplit[0], presplit[2]))
        rec = entry.record if entry is not None else None
        # the ENTIRE hot-path validation: liveness + one generation read
        # (+ the wrapper's budget, when capped)
        if rec is not None and rec.res.live and \
                rec.res.generation == rec.generation and \
                (self.tile_budget is None
                 or rec.res.tile_budget == self.tile_budget):
            return self._dispatch_fast(args, entry, rec, presplit, writeback)
        return self._call_slow(args, presplit, writeback)

    def _dispatch_fast(self, args, entry: _JitEntry, rec: _DispatchRecord,
                       presplit, writeback: bool = True):
        """Resident-hit dispatch without the overlay lock, and the fault
        plan's choke points: an injected resident loss degrades this call to
        the slow path (fallback + re-download), an injected dispatch failure
        to :meth:`_dispatch_failed`."""
        ov = self.overlay
        plan = ov.faults
        if plan is not None and plan.fires("resident_loss", rec.res.rid):
            ov._lose_resident(rec.res.rid)
            return self._call_slow(args, presplit, writeback)
        return self._dispatch(entry, rec, args, presplit, plan, writeback)

    def _dispatch(self, entry: _JitEntry, rec: _DispatchRecord, args,
                  presplit, plan: FaultPlan | None = None,
                  writeback: bool = True):
        """Run a resident's dispatch record: recency, tier bookkeeping, the
        call.  Also the specialization trigger point — a contiguous
        (zero-hop) or dispatch-stable generic resident builds its
        route-constant tier (inline on a synchronous overlay, on the
        scheduler's low lane on an asynchronous one); this call is still
        served by the record it came with."""
        ov = self.overlay
        res = rec.res
        ov.fabric.touch_resident(res)
        if ov._prefetched:
            ov._note_demand(res.rid)
        flat = pytree.tree_leaves(presplit[0])
        if rec.tier == "specialized":
            ov.cache.spec_stats.specialized_hits += 1
        elif ov._auto_specialize and res.tier == "generic" \
                and not res.spec_pending \
                and res.spec_failures < _MAX_DOWNLOAD_FAILURES:
            res.stable_dispatches += 1
            if res.zero_hop or res.stable_dispatches >= ov.specialize_after:
                if ov.async_downloads:
                    ov._request_specialize(entry, res, tuple(flat))
                else:
                    ov._specialize_now(entry, res, tuple(flat))
        t0 = time.perf_counter()
        donated = [flat[i] for _, i in entry.aliases]
        versions = [x._version for x in donated]
        try:
            if plan is not None and plan.fires("dispatch", res.rid):
                raise FaultError(f"injected dispatch failure on {res.rid!r}")
            out = rec.fn(*flat)
        except (PlacementError, FabricError):
            raise
        except Exception as exc:
            if any(x._version != v for x, v in zip(donated, versions)):
                raise          # the walk wrote into donated inputs: the
                               # fallback would read half-updated state
            return self._dispatch_failed(entry, res, exc, presplit, writeback)
        us = (time.perf_counter() - t0) * 1e6
        res.dispatch_hist.record(us)
        ov.dispatch_hist.record(us)
        leaves = list(out) if len(entry.lowered.graph.output_ids) > 1 else [out]
        return pytree.tree_unflatten(leaves, entry.lowered.out_tree), False

    def _dispatch_failed(self, entry: _JitEntry, res: ResidentAccelerator,
                         exc: BaseException, presplit, writeback: bool = True):
        """A resident dispatch raised: evict the suspect resident (its state
        is unknown), serve THIS call from the fallback — the traced function
        run eagerly, which launches the same kernels — and re-request the
        download.  An admitted call never surfaces the failure; it shows up
        as latency and in the failure ledger.  The fallback lands its
        answer in the donated inputs unless ``writeback`` is off."""
        ov = self.overlay
        ov.stats.dispatch_failures += 1
        logger.warning("dispatch on %r (%s) failed: %r — serving the "
                       "fallback", res.rid, self.name, exc)
        with ov._lock:
            res.dispatch_failures += 1
            if ov.fabric.get(res.rid) is res:
                ov._evict_resident(res.rid)
            entry.record = None
        ov.stats.dispatch_fallbacks += 1
        ov.stats.fallback_calls += 1
        out = entry.closed(*presplit[0])
        if writeback:
            out = self._land(entry, presplit[0], out)
        self._ensure_download(entry)
        return out, True

    def _call_slow(self, args, presplit, writeback: bool = True):
        entry = self._entry(args, _presplit=presplit)
        entry.calls += 1               # the deterministic retry clock
        ov = self.overlay
        acc = entry.acc
        if acc is None:
            # nothing assembled yet: serve the call from the traced function
            # run eagerly (the paper's "software fallback while the
            # bitstream downloads"); the download is requested after the
            # response is computed and the accelerator swaps in underneath
            ov.stats.fallback_calls += 1
            out = self._land(entry, presplit[0], entry.closed(*presplit[0]))
            self._ensure_download(entry)
            return out, False
        if not ov.resident_current(acc):
            # mid-re-download: the prior generation's accelerator lost its
            # PR regions but is still a correct pure function — it serves
            # while the fabric downloads this signature again
            ov.stats.fallback_calls += 1
            out = acc.fn(*pytree.tree_leaves(presplit[0]))
            self._ensure_download(entry)
            leaves = list(out) if len(entry.lowered.graph.output_ids) > 1 else [out]
            return pytree.tree_unflatten(leaves, entry.lowered.out_tree), False
        # a resident hit that missed the fast path (first dispatch, or a
        # just-invalidated record): republish, then dispatch through the
        # record so this call already serves the best live tier
        ov._publish_record(entry)
        return self._dispatch(entry, entry.record, args, presplit,
                              writeback=writeback)


class Overlay:
    """A rows×cols dynamic overlay with a shared fabric and bitstream cache.

    Args:
      rows/cols: tile grid dimensions (paper evaluates 3×3).
      policy: DYNAMIC (paper's contribution) or STATIC (baseline).
      large_fraction: fraction of LARGE tiles (paper: 1/4).
      mesh / tile_axis: a ``torch.distributed`` ``DeviceMesh`` whose
        ``tile_axis`` ranks are the tiles: each hop is then a ring shift to
        the next rank (:func:`~repro_torch.core.interpreter.assemble_sharded`),
        every rank of the mesh must make the same calls, and the overlay
        is synchronous and keeps no store entries; otherwise local
        assembly (hops as copy passes).
      cache_capacity: bitstream cache slots.
      auto_defragment: re-place surviving residents contiguously after every
        pressure reclaim (moves are relocations: no re-download).
      async_downloads: build kernels (downloads) on a background
        :class:`~repro_torch.core.scheduler.DownloadScheduler` and serve
        jit misses from a fallback until the kernel swaps in.  The default
        (False) is the deterministic synchronous mode: every miss pays its
        download on the critical path.  Forced off with a mesh: a sharded
        kernel's collectives run in step on every rank, on the caller.
      download_workers: scheduler worker threads (asynchronous mode).
      cost_aware_reclaim: reclaim the resident with the best
        age/re-download-cost ratio instead of pure LRU.  Defaults to
        following ``async_downloads``.
      auto_specialize: build the route-constant tier for residents whose
        placement is contiguous (zero pass-through hops) or whose routes
        have been stable for ``specialize_after`` dispatches, on the
        dispatch that crosses the threshold and after a defragment: on the
        scheduler's low lane on an asynchronous overlay, inline on a
        synchronous one.  Defaults to following ``async_downloads``;
        ``jitted.specialize(*args)`` works either way.
      specialize_after: dispatch-stability threshold for that trigger.
      sanitize: run the :mod:`repro_torch.analysis.check` invariant suite
        at every mutation edge and raise on the first violation.  Defaults
        to the ``REPRO_SANITIZE`` environment variable (on unless empty or
        ``0``).
      store / store_path: attach a persistent
        :class:`~repro_torch.core.store.BitstreamStore` — built kernels are
        serialized to disk on the scheduler's low lane, and a later overlay
        pointed at the same directory loads them instead of building (warm
        restarts).  Pass an existing ``store`` instance to share it, or
        ``store_path`` to open or create one; not both.  With a mesh the
        store is neither read nor written.
      cost_model_placement: replace first-fit packing with the cost-model
        planner — candidate placements at several footprint budgets scored
        in seconds-equivalent cost (measured per-hop dispatch latency,
        co-location crowding, tile scarcity), and pressure reclaims priced
        by modeled re-download cost (near zero for store-backed residents).
        Defaults to on iff a store is attached.
      autotune_thresholds: re-derive ``specialize_after`` and the
        auto-defragment trigger from live measurements.  Defaults to on iff
        a store is attached.
      faults: a :class:`~repro_torch.core.faults.FaultPlan` to inject
        download, slow-download, dispatch and resident-loss faults.
      breaker_threshold: consecutive failed downloads of an entry that open
        its circuit breaker (it then serves from the fallback and probes
        every ``breaker_probe_after`` slow-path calls, doubling on each
        failed probe).
      retry_backoff: slow-path calls before the first retry of a failed
        download, doubling per failure.
      download_deadline: seconds after which the scheduler's watchdog fails
        a background download still outstanding (None: no deadline).
      drain_timeout: seconds :meth:`close` waits for background work.
    """

    def __init__(self, rows: int = 3, cols: int = 3, *,
                 policy: PlacementPolicy = PlacementPolicy.DYNAMIC,
                 large_fraction: float = 0.25,
                 mesh: Any = None,
                 tile_axis: str = "tiles",
                 cache_capacity: int = 256,
                 auto_defragment: bool = False,
                 async_downloads: bool = False,
                 download_workers: int = 1,
                 cost_aware_reclaim: bool | None = None,
                 auto_specialize: bool | None = None,
                 specialize_after: int = 32,
                 sanitize: bool | None = None,
                 store: "BitstreamStore | None" = None,
                 store_path: "str | None" = None,
                 cost_model_placement: bool | None = None,
                 autotune_thresholds: bool | None = None,
                 faults: FaultPlan | None = None,
                 breaker_threshold: int = _MAX_DOWNLOAD_FAILURES,
                 retry_backoff: int = 1,
                 breaker_probe_after: int = 8,
                 download_deadline: float | None = None,
                 drain_timeout: float = 30.0) -> None:
        if specialize_after < 1:
            raise ValueError("specialize_after must be >= 1")
        if breaker_threshold < 1 or retry_backoff < 1 or breaker_probe_after < 1:
            raise ValueError("breaker_threshold, retry_backoff and "
                             "breaker_probe_after must be >= 1")
        if store is not None and store_path is not None:
            raise ValueError("pass store= or store_path=, not both")
        self.grid = TileGrid(rows, cols, large_fraction)
        self.policy = policy
        self.mesh = mesh
        self.tile_axis = tile_axis
        # a kernel's hop: ring shifts over the tile axis's group on a mesh,
        # copy passes otherwise
        self._hop_fn = (interp.ring_hops(interp.tile_group(mesh, tile_axis))
                        if mesh is not None else interp.local_hop)
        self.cache = BitstreamCache(cache_capacity)
        self.fabric = Fabric(self.grid)
        self.stats = OverlayStats()
        self.auto_defragment = auto_defragment
        # sharded assembly runs its collectives on the caller, in step
        self.async_downloads = bool(async_downloads) and mesh is None
        # None follows async_downloads, as in the reference
        self.cost_aware_reclaim = (self.async_downloads if cost_aware_reclaim is None
                                   else bool(cost_aware_reclaim))
        self._auto_specialize = (self.async_downloads if auto_specialize is None
                                 else bool(auto_specialize))
        self.specialize_after = int(specialize_after)
        # failure model: fault injection, retry/backoff + per-entry circuit
        # breaker, download deadlines
        self.faults = faults
        self.breaker_threshold = int(breaker_threshold)
        self.retry_backoff = int(retry_backoff)
        self.breaker_probe_after = int(breaker_probe_after)
        self.download_deadline = download_deadline
        self.drain_timeout = float(drain_timeout)
        # worker threads start at the first submit: a synchronous overlay
        # never starts one
        self.scheduler = DownloadScheduler(workers=download_workers,
                                           drain_timeout=drain_timeout)
        # one lock for every fabric and cache mutation: foreground
        # assemblies and the workers' commits serialize on it
        self._lock = threading.RLock()
        # persistent bitstream store; it turns the cost-model planner and the
        # autotuner on unless the caller says otherwise
        if store is None and store_path is not None:
            store = BitstreamStore(store_path, faults=faults)
        self.store = store
        self.cost_model_placement = ((store is not None)
                                     if cost_model_placement is None
                                     else bool(cost_model_placement))
        self.autotune_thresholds = ((store is not None)
                                    if autotune_thresholds is None
                                    else bool(autotune_thresholds))
        # sanitizer: the analysis.check suite at every mutation edge; the
        # dispatch fast path does no extra work either way (the hooks sit on
        # admit / evict / relocate / spec commit / flush, behind this flag)
        if sanitize is None:
            sanitize = os.environ.get("REPRO_SANITIZE", "") not in ("", "0")
        self.sanitize = bool(sanitize)
        # adaptive auto-defragment gate (only consulted when autotuning):
        # fragmentation below which a post-reclaim defrag is skipped
        self.defrag_threshold = 0.25
        # consecutive admissions that each paid >= 1 reclaim — the
        # planner's churn detector (flips victim selection to MRU)
        self._reclaim_streak = 0
        # optional narrowing of the reclaim victim pool: residents it
        # accepts go first (a FleetOverlay installs one per member, so that
        # copies living on another member go before sole copies)
        self.reclaim_prefer: "Callable[[ResidentAccelerator], bool] | None" = None
        self._last_placement: Placement | None = None
        self._wrappers: "weakref.WeakSet[JitAssembled]" = weakref.WeakSet()
        self._prefetched: set[str] = set()   # rids downloaded ahead of demand
        # dispatch observability: end-to-end host dispatch latency (us) and
        # total route hops per admitted or relocated placement
        self.dispatch_hist = Histogram()
        self.route_cost_hist = Histogram()
        if self.store is not None:
            # warm boot: re-seed the fabric's measurement ledger so the
            # planner prices reclaims from history instead of starting blind
            ledger = self.store.load_ledger()
            if ledger:
                with self._lock:
                    self.fabric.seed_ledger(ledger)

    def _sanity_check(self) -> None:
        """Sanitizer hook: run the full invariant suite (the caller holds
        the overlay lock).  Reached only when ``self.sanitize`` is on: the
        import stays out of every default-mode code path."""
        from repro_torch.analysis import check as _check

        _check.ensure(_check.check_overlay(self))

    def _note_demand(self, rid: str) -> None:
        """First demand access of a prefetched resident = one prefetch hit."""
        if rid in self._prefetched:
            self._prefetched.discard(rid)
            self.stats.prefetch_hits += 1

    # -- failure model --------------------------------------------------------
    def _inject_download_fault(self, key: str) -> None:
        """Chaos choke point of a kernel build (both paths): optionally
        sleep first (slow download), optionally raise :class:`FaultError`
        (failed download).  No-op without a plan."""
        plan = self.faults
        if plan is None:
            return
        if plan.slow_seconds > 0.0 and plan.fires("slow_download", key):
            time.sleep(plan.slow_seconds)
        if plan.fires("download", key):
            raise FaultError(f"injected download failure for {key!r}")

    def _lose_resident(self, rid: str) -> None:
        """Injected dispatch-time resident loss (a PR region wiped): the
        resident leaves the fabric through the one evict path; the caller
        degrades to the slow path and re-downloads."""
        with self._lock:
            if self.fabric.get(rid) is not None:
                self.stats.resident_losses += 1
                self._evict_resident(rid)

    def failure_ledger(self) -> dict[str, Any]:
        """One-stop failure accounting: retries, breaker state, dispatch
        fallbacks, watchdog timeouts (the serving engines surface it)."""
        open_breakers = sum(1 for wrapper in list(self._wrappers)
                            for entry in list(wrapper._entries.values())
                            if entry.breaker == "open")
        return {
            "download_failures": self.stats.download_failures,
            "download_retries": self.stats.download_retries,
            "breaker_opens": self.stats.breaker_opens,
            "breaker_probes": self.stats.breaker_probes,
            "breaker_closes": self.stats.breaker_closes,
            "breakers_open": open_breakers,
            "dispatch_failures": self.stats.dispatch_failures,
            "dispatch_fallbacks": self.stats.dispatch_fallbacks,
            "resident_losses": self.stats.resident_losses,
            "timed_out_downloads": self.scheduler.stats.timed_out,
        }

    # -- trace-based frontend -------------------------------------------------
    def jit(self, fn: Callable[..., Any] | None = None, *,
            strict: bool = False, name: str | None = None,
            fixed: dict[int, Coord] | None = None,
            static_argnums: tuple[int, ...] = (),
            donate_argnums: tuple[int, ...] = (),
            tile_budget: int | None = None) -> Callable[..., Any]:
        """Compile a plain PyTorch function into an overlay accelerator.

        Usable directly (``acc = overlay.jit(fn)``) or as a decorator.
        ``strict=True`` errors on aten ops without a library lowering.
        ``fixed`` pins graph nodes to tiles (static-placement experiments).
        ``donate_argnums`` donates those arguments' tensors: each output
        lands in the storage of a donated tensor of its shape and dtype and
        is returned as that tensor, so the caller must use the outputs, not
        the donated inputs' old values.  ``tile_budget`` caps this
        accelerator's fabric footprint so it can co-reside with others.
        """
        def wrap(f: Callable[..., Any]) -> JitAssembled:
            return JitAssembled(self, f, strict=strict, name=name, fixed=fixed,
                                static_argnums=static_argnums,
                                donate_argnums=donate_argnums,
                                tile_budget=tile_budget)
        return wrap if fn is None else wrap(fn)

    def aot(self, fn: Callable[..., Any], *abstract_args,
            strict: bool = False, name: str | None = None,
            fixed: dict[int, Coord] | None = None,
            tile_budget: int | None = None) -> JitAssembled:
        """Ahead-of-time assembly: pay the PR download for a signature
        before traffic arrives.  ``abstract_args`` are :class:`TensorSpec`
        pytrees (concrete tensors also work).  Calling the returned wrapper
        with matching inputs is a pure cache hit."""
        jitted = self.jit(fn, strict=strict, name=name, fixed=fixed,
                          tile_budget=tile_budget)
        jitted._entry(abstract_args, aot=True)
        return jitted

    # -- placement ------------------------------------------------------------
    def plan(self, graph: Graph, fixed: dict[int, Coord] | None = None, *,
             occupied: "set[Coord] | None" = None,
             tile_budget: int | None = None) -> tuple[Placement, Program]:
        """Placement + ISA program, without building the kernel.  Packs
        around the fabric's current residents by default (pass
        ``occupied=set()`` to plan against an empty fabric).  Does NOT
        admit the placement — a plan holds no tiles."""
        occ = self.fabric.occupied() if occupied is None else occupied
        placement = place(graph, self.grid, self.policy, fixed,
                          occupied=occ, max_tiles=tile_budget)
        return placement, compile_graph(graph, placement)

    def _resident_key(self, graph: Graph, avals: tuple,
                      fixed: dict[int, Coord] | None) -> str:
        # `fixed` is part of the accelerator's identity: the same graph
        # pinned to different tiles is a different placement
        pins = repr(sorted(fixed.items())) if fixed else ""
        return cache_lib.cache_key(graph.name, cache_lib.signature_of(avals),
                                   placement_desc=pins,
                                   extra="resident:" + graph.fingerprint())

    def _kernel_key(self, graph: Graph, avals: tuple,
                    jit_kwargs: dict[str, Any] | None = None) -> str:
        """Placement-FREE identity of the kernel artifact: one kernel serves
        every placement of this graph (routes are a runtime argument).  The
        jit kwargs (donation) are part of it: a donated and an undonated
        kernel of one graph never share a cache or store entry; so is the
        mesh axis a sharded kernel's hops cross."""
        return cache_lib.kernel_key(graph.name, cache_lib.signature_of(avals),
                                    fingerprint=graph.fingerprint(),
                                    extra=repr(sorted((jit_kwargs or {}).items()))
                                    if jit_kwargs else "",
                                    mesh_desc=self._mesh_desc())

    def _mesh_desc(self) -> str:
        """The tile axis and the mesh's shape, or "" for a local overlay."""
        if self.mesh is None:
            return ""
        return f"{self.tile_axis}@{dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))}"

    def resident_current(self, acc: interp.AssembledAccelerator) -> bool:
        """Whether an assembled accelerator still holds its PR regions."""
        return self.fabric.is_current(acc.resident_id, acc.generation)

    def _place_with_reclaim(self, graph: Graph,
                            fixed: dict[int, Coord] | None,
                            tile_budget: int | None) -> Placement:
        """Place into free tiles; on pressure, reclaim residents (tiles +
        bitstreams via the one evict path) until the graph fits or the
        fabric is empty.  Victim order is LRU, or age-per-re-download-cost
        with ``cost_aware_reclaim``.  A graph that cannot fit even an
        *empty* fabric is structurally unplaceable: it re-raises before
        evicting anyone.  With ``cost_model_placement`` the planner
        replaces first-fit."""
        if self.cost_model_placement:
            return self._plan_with_cost_model(graph, fixed, tile_budget)
        probed = False
        while True:
            try:
                return place(graph, self.grid, self.policy, fixed,
                             occupied=self.fabric.occupied(),
                             max_tiles=tile_budget)
            except PlacementError:
                victim = self.fabric.reclaim_victim(
                    cost_aware=self.cost_aware_reclaim,
                    prefer=self.reclaim_prefer)
                if victim is None:
                    raise
                if not probed:
                    place(graph, self.grid, self.policy, fixed,
                          occupied=frozenset(), max_tiles=tile_budget)
                    probed = True
                self._evict_resident(victim.rid)
                self.stats.reclaims += 1
                self._maybe_defragment()

    # -- cost-model placement planner -----------------------------------------
    # price priors (seconds) for quantities not yet measured in this process
    _RECLAIM_PRIOR_S = 0.05       # a re-download (kernel build)
    _STORE_LOAD_PRIOR_S = 0.005   # a store load

    def _reclaim_prior(self) -> float:
        """Neutral re-download price: the mean measured cost, else a prior."""
        mean = self.fabric.mean_download_cost()
        return mean if mean > 0.0 else self._RECLAIM_PRIOR_S

    def _planner_hop_cost(self) -> float:
        """Per-hop steady-state price: a slice of the measured p50 dispatch
        latency, clamped; a fixed default until enough dispatches have
        landed for the p50 to stop reflecting cold first calls."""
        if self.dispatch_hist.count >= 16:
            p50_s = self.dispatch_hist.percentile(0.5) * 1e-6
            return min(1e-3, max(1e-5, 0.05 * p50_s))
        return 1e-4

    def _victim_price(self, res: ResidentAccelerator) -> float:
        """Modeled cost of reclaiming ``res`` now: what the next admission
        would pay to bring its kernels back.  The mean measured store load
        (else a prior) when every kernel it owns is store-backed — the load
        replaces the build — otherwise its measured download cost, else
        the neutral prior."""
        if self.store is not None and res.cache_keys \
                and all(k in self.store for k in res.cache_keys):
            st = self.cache.stats
            if st.store_hits:
                return st.store_load_seconds / st.store_hits
            return self._STORE_LOAD_PRIOR_S
        cost = self.fabric.download_cost(res.rid) or res.download_cost
        return cost if cost > 0.0 else self._reclaim_prior()

    def _plan_with_cost_model(self, graph: Graph,
                              fixed: dict[int, Coord] | None,
                              tile_budget: int | None) -> Placement:
        """Cost-model replacement for first-fit: feasible candidates at
        several footprint budgets, the cheapest adopted in
        seconds-equivalent cost (hops at the measured per-hop price,
        co-location crowding, tile scarcity).  The quadratic scarcity term
        makes footprint expensive as the fabric fills, so admissions
        compact into fewer tiles instead of reclaiming whenever crowding is
        cheaper than the modeled re-download.  When nothing fits, the
        planner's victim is reclaimed and planning retries."""
        probed = False
        evicted = False
        while True:
            occ = self.fabric.occupied()
            cands = candidate_placements(graph, self.grid, self.policy, fixed,
                                         occupied=occ, max_tiles=tile_budget)
            if cands:
                self._reclaim_streak = (self._reclaim_streak + 1) if evicted \
                    else 0
                hop_s = self._planner_hop_cost()
                return min(cands, key=lambda p: score_placement(
                    p, hop_cost_s=hop_s, crowd_cost_s=2.0 * hop_s,
                    occupied_tiles=len(occ), num_tiles=self.grid.num_tiles,
                    tile_pressure_s=self._reclaim_prior()))
            victim = self._select_victim()
            if victim is None:
                # empty fabric and still unplaceable: place() raises
                return place(graph, self.grid, self.policy, fixed,
                             occupied=occ, max_tiles=tile_budget)
            if not probed:
                place(graph, self.grid, self.policy, fixed,
                      occupied=frozenset(), max_tiles=tile_budget)
                probed = True
            self._evict_resident(victim.rid)
            evicted = True
            self.stats.reclaims += 1
            self._maybe_defragment()

    def _select_victim(self) -> "ResidentAccelerator | None":
        """The planner's reclaim victim: the fabric's cost-aware choice
        under :meth:`_victim_price`, BUT when each of the last
        ``len(pool)`` admissions paid a reclaim the working set has
        outgrown the fabric and age order is pathological (a cyclic
        rotation's LRU resident is the one needed next).  Then the most
        recently used resident within 2x of the cheapest modeled
        re-download goes (Belady's rule for a loop longer than the cache)."""
        pool = list(self.fabric.residents.values())
        if not pool:
            return None
        if self.reclaim_prefer is not None:
            preferred = [r for r in pool if self.reclaim_prefer(r)]
            if preferred:
                pool = preferred
        if self._reclaim_streak >= len(pool):
            prices = {r.rid: self._victim_price(r) for r in pool}
            cheapest = min(prices.values())
            mru_pool = [r for r in pool
                        if prices[r.rid] <= 2.0 * cheapest + 1e-9]
            return max(mru_pool, key=lambda r: r.last_used)
        return self.fabric.reclaim_victim(cost_aware=True,
                                          prefer=self.reclaim_prefer,
                                          price=self._victim_price)

    def _maybe_defragment(self) -> None:
        """Post-reclaim defragment gate.  Plain ``auto_defragment`` runs a
        pass after every reclaim; with ``autotune_thresholds`` the pass runs
        only once fragmentation crosses an adaptive threshold, which a pass
        that moved nobody raises and a pass that compacted lowers."""
        if not self.auto_defragment:
            return
        if not self.autotune_thresholds:
            self.defragment()
            return
        if self.fabric.fragmentation() < self.defrag_threshold:
            return
        if self.defragment() == 0:
            self.defrag_threshold = min(0.9, self.defrag_threshold * 1.5 + 0.01)
        else:
            self.defrag_threshold = max(0.02, self.defrag_threshold * 0.75)

    def _autotune(self) -> None:
        """Re-derive ``specialize_after`` from measurements (no-op unless
        ``autotune_thresholds``): amortize the mean specialization cost
        over dispatches at the measured p50 latency, assuming a 25% saving
        a dispatch, clamped to [8, 512]."""
        if not self.autotune_thresholds:
            return
        ss = self.cache.spec_stats
        if not ss.specializations or not self.dispatch_hist.count:
            return
        spec_cost = ss.compile_seconds / ss.specializations
        p50_s = self.dispatch_hist.percentile(0.5) * 1e-6
        if p50_s <= 0.0 or spec_cost <= 0.0:
            return
        self.specialize_after = min(512, max(8, int(spec_cost / (0.25 * p50_s))))

    # -- admission and assembly -----------------------------------------------
    def _get_or_admit(self, graph: Graph, rid: str,
                      fixed: dict[int, Coord] | None,
                      tile_budget: int | None, *,
                      reclaim: bool = True) -> ResidentAccelerator:
        """Resident lookup-or-admission (the PR download decision); the
        caller holds the overlay lock.  ``reclaim=False`` raises
        :class:`PlacementError` under pressure instead of evicting (hint
        paths that must not displace live residents)."""
        resident = self.fabric.get(rid)
        if resident is not None:
            self.fabric.touch(rid)
            if tile_budget is not None and tile_budget != resident.tile_budget:
                # budget repack: re-place under the new footprint cap and
                # RELOCATE — the kernel is placement-free, so a resize
                # never pays a re-download
                self._repack_budget(resident, tile_budget)
            return resident
        if reclaim:
            placement = self._place_with_reclaim(graph, fixed, tile_budget)
        else:
            placement = place(graph, self.grid, self.policy, fixed,
                              occupied=self.fabric.occupied(),
                              max_tiles=tile_budget)
        program = compile_graph(graph, placement)
        resident = self.fabric.admit(rid, graph.name, graph, placement,
                                     program, tile_budget=tile_budget,
                                     fixed=fixed)
        self._bind_routes_eager(resident)
        self.stats.downloads += 1
        # only a real re-place changes the fabric layout
        if self._last_placement is not None and \
                placement.assignment != self._last_placement.assignment:
            self.stats.reconfigurations += 1
        self._last_placement = placement
        if self.sanitize:
            self._sanity_check()
        return resident

    def _bind_routes_eager(self, resident: ResidentAccelerator) -> None:
        """Build the resident's routes vector ONCE, at admit/relocate time
        — dispatch only ever reads ``resident.routes``."""
        graph, placement = resident.graph, resident.placement
        resident.routes = self.cache.route_program(
            resident.rid, placement.descriptor(),
            lambda: interp.route_vector(graph, placement))
        hops = interp.route_hops(graph, placement)
        resident.zero_hop = interp.zero_hop(hops)
        resident.route_cost = int(sum(hops))
        self.route_cost_hist.record(resident.route_cost)

    def _bind_acc(self, resident: ResidentAccelerator,
                  kernel: interp.Kernel) -> interp.AssembledAccelerator:
        """The resident's accelerator: ``kernel`` bound to its current
        routes (rebuilt only after a move or a kernel change)."""
        if resident.acc is None or resident.acc.kernel is not kernel:
            acc = interp.assemble(resident.graph, resident.placement,
                                  program=resident.program,
                                  routes=resident.routes, kernel=kernel)
            resident.acc = dataclasses.replace(
                acc, resident_id=resident.rid, generation=resident.generation)
        return resident.acc

    def assemble(self, graph: Graph, *,
                 fixed: dict[int, Coord] | None = None,
                 tile_budget: int | None = None,
                 jit_kwargs: dict[str, Any] | None = None
                 ) -> interp.AssembledAccelerator:
        """JIT-assemble ``graph`` into a fabric-resident accelerator (cached).

        If the same graph+signature is already resident this is a pure hit:
        its placement (and tiles) are reused and its recency is bumped.
        Otherwise the graph is placed into the free tiles — reclaiming
        residents under pressure — admitted as a new resident, and its
        kernel is built (a download) unless the cache already holds it:
        the kernel is placement-free, so a re-admission at another
        placement reuses it.  This path is synchronous: the download is paid
        before it returns (the asynchronous pipeline is
        :meth:`submit_download`)."""
        with self._lock:
            graph.validate()
            avals = graph.input_avals()
            rid = self._resident_key(graph, avals, fixed)
            hit = self.fabric.get(rid) is not None
            resident = self._get_or_admit(graph, rid, fixed, tile_budget)
            if hit:
                self._note_demand(rid)
            self.stats.assemblies += 1
            key = self._kernel_key(graph, avals, jit_kwargs)
            if key in resident.cache_keys and key not in self.cache:
                # the cache's own LRU dropped a resident's kernel: rebuilding
                # it is a real re-download — keep the ledger honest
                resident.cache_keys = tuple(k for k in resident.cache_keys
                                            if k in self.cache)
                self.stats.downloads += 1
            if key in self.cache:
                # pure hit: the kernel is placement-free, so it serves this
                # resident's current routes
                kernel = self.cache.get_or_compile(key, lambda: None)
                self.fabric.add_cache_key(rid, key)
                return self._bind_acc(resident, kernel)
            generation = resident.generation
        # miss: load or build OUTSIDE the lock, as the reference compiles —
        # neither may stall concurrent requests or background commits
        kernel, dt, loaded = self._load_or_build(key, graph, jit_kwargs)
        with self._lock:
            if self.fabric.same_residency(rid, generation):
                self._book_kernel_locked(rid, key, kernel, dt, loaded)
                # relocated meanwhile? the kernel is placement-free: bind it
                # to the routes as they stand now
                return self._bind_acc(self.fabric.get(rid), kernel)
        # reclaimed while building: publish nothing; the kernel is still a
        # correct pure function, so the caller gets it at the old routes
        # (a stale generation: the next call re-assembles)
        acc = interp.assemble(resident.graph, resident.placement,
                              program=resident.program, routes=resident.routes,
                              kernel=kernel)
        return dataclasses.replace(acc, resident_id=rid, generation=generation)

    # -- asynchronous download pipeline ---------------------------------------
    def submit_download(self, graph: Graph, *,
                        fixed: dict[int, Coord] | None = None,
                        tile_budget: int | None = None,
                        on_done: "Callable[[Any, DownloadHandle], None] | None"
                        = None,
                        kind: str = "demand",
                        reclaim: bool = True,
                        low: bool = False,
                        jit_kwargs: dict[str, Any] | None = None
                        ) -> DownloadHandle:
        """Begin an asynchronous PR download for ``graph``.

        Foreground (under the overlay lock): place the graph — reclaiming
        under pressure — and admit it at once, so its PR regions are held
        while the kernel is in flight and concurrent placements pack around
        it.  Background (a scheduler worker): the kernel build.  Commit
        (the worker, back under the lock): publish the kernel, its cache
        entry and its measured build time, but only if the residency is
        still the one admitted here (``Fabric.same_residency``); a resident
        evicted or flushed mid-download stays evicted.  ``on_done``
        observers receive the routes-bound
        :class:`~repro_torch.core.interpreter.AssembledAccelerator` (or
        None).  A kernel already in the cache completes inline with an
        already-done handle."""
        with self._lock:
            graph.validate()
            avals = graph.input_avals()
            rid = self._resident_key(graph, avals, fixed)
            resident = self._get_or_admit(graph, rid, fixed, tile_budget,
                                          reclaim=reclaim)
            key = self._kernel_key(graph, avals, jit_kwargs)
            if kind == "prefetch":
                self.stats.prefetches += 1
                self._prefetched.add(rid)
            kernel = self.cache.peek(key)
            if kernel is not None:
                # the kernel is placement-free: bind this resident's routes
                # and complete inline
                self.cache.get_or_compile(key, lambda: kernel)   # count the hit
                self.fabric.add_cache_key(rid, key)
                handle = DownloadHandle(key=rid, kind=kind)
                handle.result = self._bind_acc(resident, kernel)
                handle.status = "done"
                handle._event.set()
                if on_done is not None:
                    on_done(handle.result, handle)
                return handle
            pending = _PendingDownload(rid=rid, generation=resident.generation,
                                       key=key, graph=graph, jit_kwargs=jit_kwargs)
        return self.scheduler.submit(
            rid, lambda: self._compile_bitstream(pending),
            lambda built, dt: self._commit_download(pending, built, dt),
            on_done=on_done, kind=kind, low=low,
            deadline=self.download_deadline)

    def _compile_bitstream(self, pending: _PendingDownload
                           ) -> "tuple[interp.Kernel, float, bool]":
        """The expensive half of a download, on a scheduler worker with no
        lock held: the placement-invariant kernel, off the store or built."""
        return self._load_or_build(pending.key, pending.graph, pending.jit_kwargs)

    def _load_or_build(self, key: str, graph: Graph,
                       jit_kwargs: dict[str, Any] | None = None
                       ) -> "tuple[interp.Kernel, float, bool]":
        """A missing kernel, with no lock held: loaded from the bitstream
        store when it holds a usable entry, else built (the download, and
        the fault plan's choke point).  Returns ``(kernel, seconds,
        loaded)``."""
        t0 = time.perf_counter()
        kernel = self._store_load(key)
        if kernel is not None:
            return kernel, time.perf_counter() - t0, True
        self._inject_download_fault(key)
        t0 = time.perf_counter()
        kernel = interp.build_kernel(
            graph, cache_lib.kernel_jit_kwargs(jit_kwargs).get("donate_argnums", ()),
            self._hop_fn)
        return kernel, time.perf_counter() - t0, False

    def _book_kernel_locked(self, rid: str, key: str, kernel: interp.Kernel,
                            seconds: float, loaded: bool) -> None:
        """Publish a loaded or built kernel for a resident (the caller holds
        the lock): the cache entry (a store hit is a miss that paid a load,
        not a build), the measured cost the planner prices with, the
        resident's key, and a persist of a built kernel."""
        if loaded:
            self.cache.insert_loaded(key, kernel, seconds)
        else:
            self.cache.insert_compiled(key, kernel, seconds)
            self._persist_artifact_locked(key, kernel)
        self.fabric.record_download_cost(rid, seconds)
        self.fabric.add_cache_key(rid, key)

    def _commit_download(self, pending: _PendingDownload,
                         built: "tuple[interp.Kernel, float, bool]",
                         seconds: float) -> interp.AssembledAccelerator | None:
        """Publish a finished background build (the swap), on the worker
        under the overlay lock.  A residency evicted or flushed while the
        kernel built is not resurrected (None: the scheduler counts it
        stale); one that merely RELOCATED still commits — the kernel is
        placement-free — bound to the routes as they stand now."""
        with self._lock:
            if not self.fabric.same_residency(pending.rid, pending.generation):
                self.stats.stale_downloads += 1
                return None
            # the worker's measured time (a load, or a build with any
            # injected slowness) is what the planner should price
            kernel, _, loaded = built
            self._book_kernel_locked(pending.rid, pending.key, kernel, seconds,
                                     loaded)
            return self._bind_acc(self.fabric.get(pending.rid), kernel)

    def prefetch(self, jitted: JitAssembled, *args) -> DownloadHandle | None:
        """Engine-level prefetch hint, the same as ``jitted.prefetch(*args)``."""
        if jitted.overlay is not self:
            raise ValueError("jitted wrapper belongs to a different overlay")
        return jitted.prefetch(*args)

    def drain(self, timeout: float | None = None) -> bool:
        """Wait until no background job is queued or running (and every
        completion swap has been delivered)."""
        return self.scheduler.drain(timeout)

    def close(self, *, drain_timeout: float | None = None) -> None:
        """End of life for the download pipeline: cancel outstanding jobs,
        wait for running ones (``drain_timeout`` overrides the
        constructor's; a timed-out drain warns with the undrained count)
        and retire the workers.  The overlay keeps serving: synchronous
        paths are unaffected, and asynchronous misses serve their fallback
        for good (no new download starts).

        With a store attached, queued persists drain FIRST (shutdown
        cancels what is queued) and the measurement ledger gets a final
        save: a clean close is what lets the next boot find everything on
        disk.

        A mesh overlay also drops every resident's specialized tier and
        frees its captured CUDA graphs, and captures none after: a live
        graph that captured an NCCL collective makes
        ``torch.distributed.destroy_process_group`` hang.  Its residents
        keep serving on the generic tier."""
        limit = self.drain_timeout if drain_timeout is None else drain_timeout
        if self.store is not None and not self.scheduler.closed:
            if not self.scheduler.drain(timeout=limit):
                logger.warning(
                    "overlay close: %d background job(s) still undrained "
                    "after %.1fs; persisting the ledger anyway",
                    self.scheduler.outstanding(), limit)
            self.store.save_ledger(self.fabric.export_ledger())
        self.scheduler.shutdown(wait=True, timeout=limit)
        if self.mesh is not None:
            self._release_captures()

    def _release_captures(self) -> None:
        """Every resident back on its generic tier, every specialized
        artifact released (:func:`~repro_torch.core.cache.release_artifact`)
        and every dispatch record republished on the generic kernel."""
        with self._lock:
            for res in self.fabric.residents.values():
                if res.tier == "specialized":
                    self.cache.spec_stats.despecializations += 1
                res.tier = "generic"
                res.spec_fn = res.spec_job = None
                res.spec_pending = False
            self.cache.drop_all_specialized()
            for wrapper in list(self._wrappers):
                for entry in list(wrapper._entries.values()):
                    self._publish_record(entry)

    # -- persistent bitstream store -------------------------------------------
    def _store_load(self, key: str) -> "interp.Kernel | None":
        """A cache miss satisfied from the bitstream store (no lock held;
        the caller books it), or None — a plain miss, an entry that fails
        validation, or a payload that does not rebuild — and the caller
        builds cold.  A payload that passes the checksum but does not
        rebuild (an operator or a tag this build cannot resolve) is
        expunged so the next boot does not trip over it again.  A mesh
        overlay reads nothing from the store."""
        if self.store is None or self.mesh is not None:
            return None
        blob = self.store.load_blob(key)
        if blob is None:
            return None
        try:
            return BitstreamStore.unpack_kernel(blob)
        except Exception as exc:  # noqa: BLE001 — any failure = cold build
            self.store.note_unusable(key)
            logger.warning("bitstream store: entry for %r failed to "
                           "deserialize (%s); cold compiling", key, exc)
            return None

    def _persist_artifact_locked(self, key: str, kernel: interp.Kernel) -> None:
        """Queue ``kernel`` for persistence on the scheduler's LOW lane (the
        caller holds the lock): a persist never delays a download.
        Serialization runs on a worker with no lock held; the disk write
        commits back under the lock only if the kernel is still cached.
        A sharded kernel is not written: its hops name a process group."""
        if self.store is None or self.mesh is not None or self.scheduler.closed \
                or key in self.store:
            return
        self.scheduler.submit(
            f"persist:{key}", lambda: self._pack(key, kernel),
            lambda blob, dt: self._commit_persist(key, blob, "kernel"),
            kind="persist", low=True)

    def _pack(self, key: str, kernel: Any) -> "bytes | None":
        """Worker half of a persist (no lock held): the kernel's serial form,
        or None when it has none (an operator built from an arbitrary
        callable, a const that is not a tensor or a number).  Such a kernel
        still serves; it is only not written, and the store counts it."""
        try:
            return BitstreamStore.pack_kernel(kernel)
        except SerialError as exc:
            self.store.note_unpersistable(key, exc)
            return None

    def _commit_persist(self, key: str, blob: "bytes | None", store_kind: str):
        """Write a serialized artifact to the store (a worker, under the
        lock).  Guarded like a download commit: it persists only entries
        the cache still serves, so an evict that raced the serialization
        wins and the disk never holds a resurrected key."""
        with self._lock:
            if self.store is None or blob is None:
                return None
            if store_kind == "specialized":
                alive = self.cache.specialized(key) is not None
            else:
                alive = key in self.cache
            if not alive:
                return None
            ok = self.store.save(key, blob, kind=store_kind)
            if ok:
                # the measurement ledger rides every successful persist:
                # restarts re-seed the EWMA costs and latency histograms
                self.store.save_ledger(self.fabric.export_ledger())
            return ok or None

    def _persist_spec_locked(self, pending: "_PendingSpecialize", exe: Any) -> None:
        """Queue the route-constant tier for persistence (the caller holds
        the lock).  A CUDA graph does not serialize: what is written is the
        walk it captured (the hop vector plus the step list), from which a
        warm boot captures again.  A mesh overlay writes none."""
        if self.store is None or self.mesh is not None or self.scheduler.closed \
                or pending.spec_key in self.store:
            return
        kernel = getattr(exe, "kernel", exe)
        self.scheduler.submit(
            f"persist:{pending.spec_key}",
            lambda: self._pack(pending.spec_key, kernel),
            lambda blob, dt: self._commit_persist(pending.spec_key, blob,
                                                  "specialized"),
            kind="persist", low=True)

    def _publish_record(self, entry: _JitEntry) -> None:
        """(Re)derive an entry's dispatch record from its accelerator,
        picking the best live tier: the resident's specialized artifact
        when it carries one, else the generic routes-bound kernel.  A
        non-current residency publishes None."""
        acc = entry.acc
        rec = None
        res = self.fabric.get(acc.resident_id) if acc is not None else None
        if res is not None and res.generation == acc.generation:
            fn, tier = acc.fn, "generic"
            if res.tier == "specialized" and res.spec_fn is not None \
                    and entry.jit_kwargs == res.spec_jit_kwargs:
                fn, tier = res.spec_fn, "specialized"
            rec = _DispatchRecord(fn=fn, res=res, generation=res.generation,
                                  tier=tier)
        entry.record = rec

    # -- relocation -----------------------------------------------------------
    def _repack_budget(self, resident: ResidentAccelerator,
                       tile_budget: int | None) -> None:
        """Re-place a resident under a changed footprint cap via relocation.
        Best-effort: under pressure the old placement stands and the new
        budget applies at the next re-place."""
        occ = self.fabric.occupied() - resident.tiles
        try:
            pl = place(resident.graph, self.grid, self.policy, resident.fixed,
                       occupied=occ, max_tiles=tile_budget)
        except PlacementError:
            resident.tile_budget = tile_budget
            return
        resident.tile_budget = tile_budget
        if pl.assignment != resident.placement.assignment:
            self._relocate_resident(resident.rid, pl)

    def _relocate_resident(self, rid: str, placement: Placement,
                           ignore: "tuple[str, ...]" = ()
                           ) -> ResidentAccelerator:
        """THE relocation path: re-emit the controller program and the
        routes for the new placement, rehome the tiles and rebind the live
        jit entries.  Kernel artifacts, the bitstream cache and the
        download ledger are untouched — the move costs route emission, not
        a PR download."""
        res = self.fabric.get(rid)
        program = compile_graph(res.graph, placement)
        # the routes are about to change: the route-constant tier is
        # unusable the moment they do — despecialize FIRST, then rehome
        self._despecialize(res)
        # old-placement route programs die with the move
        self.cache.evict_routes(rid)
        res = self.fabric.relocate(rid, placement, program, ignore=ignore)
        self._bind_routes_eager(res)
        self.stats.relocations += 1
        if self.async_downloads and not self.scheduler.closed:
            gen = res.generation
            self.scheduler.submit(
                f"relocate:{rid}", lambda: None,
                lambda _raw, _dt, rid=rid, gen=gen: self._rebind_resident(rid, gen),
                kind="relocate", priority=True)
        else:
            self._rebind_resident(rid)
        # a planned repack (ignore non-empty) passes through legal transient
        # overlap between movers: the plan's caller checks once at the end
        if self.sanitize and not ignore:
            self._sanity_check()
        return res

    def _rebind_resident(self, rid: str, generation: int | None = None
                         ) -> interp.AssembledAccelerator | None:
        """Rebind every live jit entry of ``rid`` onto its cached kernel
        with the resident's current routes (cheap: no build), so the first
        call after a move already takes the fast path.  Inline after a move
        on a synchronous overlay; the commit of a priority job on an
        asynchronous one, guarded by ``same_residency`` (back-to-back moves
        coalesce onto the first job, and the rebind reads the resident's
        CURRENT routes).  Returns the bound accelerator, None when the
        resident or its kernel is gone (the demand path re-downloads)."""
        with self._lock:
            if generation is not None and \
                    not self.fabric.same_residency(rid, generation):
                return None
            res = self.fabric.get(rid)
            avals = res.graph.input_avals()
            acc = None
            for wrapper in list(self._wrappers):
                for entry in list(wrapper._entries.values()):
                    if entry.acc is None or entry.acc.resident_id != rid:
                        continue
                    # each entry keeps its own kernel (a donated one and an
                    # undonated one may share the resident)
                    kernel = self.cache.peek(self._kernel_key(res.graph, avals,
                                                              entry.jit_kwargs))
                    if kernel is None:
                        continue
                    entry.acc = acc = self._bind_acc(res, kernel)
                    self._publish_record(entry)
            return acc

    def repack(self, rid: str, tile_budget: int | None) -> bool:
        """Re-place a resident under a changed footprint cap via relocation.
        No-op (False) when ``tile_budget`` is None, unchanged, or the rid is
        not resident; True when the resident actually moved."""
        if tile_budget is None:
            return False
        # lock-free pre-check: this runs on the slow dispatch path, which
        # must not wait on a worker's commit when nothing changed
        res = self.fabric.get(rid)
        if res is None or res.tile_budget == tile_budget:
            return False
        with self._lock:
            res = self.fabric.get(rid)
            if res is None or res.tile_budget == tile_budget:
                return False
            gen = res.generation
            self._repack_budget(res, tile_budget)
            return self.fabric.get(rid).generation != gen

    def relocate(self, target: "Graph | str",
                 placement: Placement) -> ResidentAccelerator:
        """Move a resident accelerator to ``placement`` without paying a
        re-download.  ``target`` is a graph, an accelerator name (as
        :meth:`evict` takes — must name exactly one resident), or a
        resident id.  The new tiles must be free of *other* residents, and
        the placement must pass :func:`check_assignment`.  Returns the
        relocated resident."""
        with self._lock:
            return self._relocate_target(target, placement)

    def _relocate_target(self, target: "Graph | str",
                         placement: Placement) -> ResidentAccelerator:
        if isinstance(target, Graph):
            rid = self._resident_key(target, target.input_avals(), None)
        else:
            rid = str(target)
            if self.fabric.get(rid) is None:
                named = [r.rid for r in self.fabric.residents.values()
                         if r.name == rid]
                if len(named) > 1:
                    raise FabricError(
                        f"relocate: {rid!r} names {len(named)} residents "
                        f"— pass a specific resident id")
                if named:
                    rid = named[0]
        res = self.fabric.get(rid)
        if res is None:
            raise FabricError(f"relocate: no resident for {target!r}")
        # internal paths build placements via place(); a user-supplied one
        # must prove the same invariants before touching the fabric
        check_assignment(res.graph, self.grid, placement)
        return self._relocate_resident(rid, placement)

    def defragment(self) -> int:
        """Re-place surviving residents contiguously (most-recently-used
        first) to close occupancy holes left by evictions.

        Moves are **relocations**: a moved resident keeps its kernel and
        its download ledger; only the route program is re-emitted.
        All-or-nothing: if any survivor fails to re-place, nothing moves,
        ``stats.defrag_failures`` counts the aborted pass and a warning
        names the blocking resident.  Returns the number of residents
        moved."""
        with self._lock:
            return self._defragment_locked()

    def _defragment_locked(self) -> int:
        def abort(res: ResidentAccelerator, exc: PlacementError) -> bool:
            self.stats.defrag_failures += 1
            logger.warning(
                "defragment aborted: resident %r (%s, %d tiles, "
                "tile_budget=%s) cannot be re-placed — %s",
                res.rid, res.name, len(res.tiles), res.tile_budget, exc)
            return False

        plan = self._plan_repack(abort)
        if plan is None:
            return 0
        moved = 0
        plan_rids = tuple(res.rid for res, _ in plan)
        for res, pl in plan:
            if pl.assignment == res.placement.assignment:
                continue
            self._relocate_resident(res.rid, pl, ignore=plan_rids)
            moved += 1
        if moved:
            self.stats.defrags += 1
            # compaction's point is the contiguous steady state: build the
            # zero-hop tier for residents that reached it
            self._enqueue_contiguous_specializations()
        if self.sanitize:
            self._sanity_check()
        return moved

    def _plan_repack(self, on_failure: "Callable[[ResidentAccelerator, PlacementError], bool]"
                     ) -> "list[tuple[ResidentAccelerator, Placement]] | None":
        """The shared re-place planner behind defragment() and
        reconfigure(relocate=True): MRU-first plan over movable residents,
        pinned residents anchoring the packing.  ``on_failure(res, exc)``
        decides what an unplaceable survivor means — True skips it and
        keeps planning, False aborts (None is returned)."""
        survivors = self.fabric.lru_order()[::-1]   # MRU packs first
        plan: list[tuple[ResidentAccelerator, Placement]] = []
        scratch: set[Coord] = set()
        for res in survivors:
            if res.fixed is not None:
                scratch |= res.tiles
        for res in survivors:
            if res.fixed is not None:
                continue
            try:
                pl = place(res.graph, self.grid, self.policy,
                           occupied=scratch, max_tiles=res.tile_budget)
            except PlacementError as exc:
                if on_failure(res, exc):
                    continue
                return None
            plan.append((res, pl))
            scratch |= set(pl.assignment.values())
        return plan

    # -- tiered route specialization ------------------------------------------
    def _spec_snapshot_locked(self, entry: _JitEntry, res: ResidentAccelerator,
                              inputs: tuple | None) -> _PendingSpecialize | None:
        """What to specialize (entry, res) from, or None when it is
        impossible or pointless now (the caller holds the lock): one variant
        per resident at a time, and a resident whose specialization keeps
        failing stops being retried at these routes."""
        if not res.live or res.tier != "generic" or res.spec_pending \
                or res.spec_failures >= _MAX_DOWNLOAD_FAILURES:
            return None
        acc = entry.acc
        if acc is not None and acc.resident_id != res.rid:
            return None
        graph = entry.lowered.graph
        key = self._kernel_key(graph, graph.input_avals(), entry.jit_kwargs)
        hops = interp.route_hops(graph, res.placement)
        return _PendingSpecialize(
            rid=res.rid, generation=res.generation, key=key,
            spec_key=cache_lib.spec_key(key, hops), graph=graph, hops=hops,
            inputs=inputs or (None,) * len(graph.input_ids),
            jit_kwargs=entry.jit_kwargs)

    def _request_specialize(self, entry: _JitEntry, res: ResidentAccelerator,
                            inputs: tuple | None) -> DownloadHandle | None:
        """The dispatch-path trigger on an asynchronous overlay: queue the
        route-constant build on the scheduler's low lane."""
        if self.scheduler.closed:
            return None
        with self._lock:
            return self._submit_specialize_locked(entry, res, inputs)

    def _submit_specialize_locked(self, entry: _JitEntry,
                                  res: ResidentAccelerator,
                                  inputs: tuple | None) -> DownloadHandle | None:
        pending = self._spec_snapshot_locked(entry, res, inputs)
        if pending is None:
            return None
        res.spec_pending = True
        res.spec_job = f"specialize:{pending.spec_key}"
        return self.scheduler.submit(
            res.spec_job,
            lambda: self._compile_specialized_tier(pending),
            lambda exe, dt: self._commit_specialized(pending, exe, dt),
            on_done=lambda result, h: self._spec_settled(pending, result, h),
            kind="specialize", low=True)

    def _spec_settled(self, pending: _PendingSpecialize, result,
                      handle: DownloadHandle) -> None:
        """Observer of a background specialization: one that FAILED (or was
        dropped) must not leave the resident wedged in ``spec_pending``,
        which every trigger reads.  Failures are counted and capped; the
        generic tier keeps serving either way."""
        if result is not None:
            return                       # committed: state already settled
        with self._lock:
            res = self.fabric.get(pending.rid)
            if res is None or res.generation != pending.generation:
                return                   # relocated/evicted: already reset
            res.spec_pending = False
            res.spec_job = None
            if handle.error is not None:
                res.spec_failures += 1
                if res.spec_failures == 1:
                    warnings.warn(
                        f"background specialization for {res.name!r} failed "
                        f"({handle.error!r}); the generic kernel keeps "
                        f"serving. Giving up after {_MAX_DOWNLOAD_FAILURES} "
                        f"attempts.", RuntimeWarning, stacklevel=2)

    def _specialize_now(self, entry: _JitEntry, res: ResidentAccelerator,
                        inputs: tuple | None) -> Any:
        """Build the route-constant tier on the caller and commit it (a
        synchronous overlay, or an explicit request on a closed scheduler).
        A failure is counted on the resident and re-raised: there is no
        quiet fallback to the generic tier."""
        with self._lock:
            pending = self._spec_snapshot_locked(entry, res, inputs)
            if pending is None:
                return None
            res.spec_pending = True
            res.spec_job = f"specialize:{pending.spec_key}"
        t0 = time.perf_counter()
        try:
            exe = self._compile_specialized_tier(pending)
        except BaseException:
            with self._lock:
                if self.fabric.is_current(pending.rid, pending.generation):
                    res.spec_pending = False
                    res.spec_job = None
                    res.spec_failures += 1
            raise
        return self._commit_specialized(pending, exe, time.perf_counter() - t0)

    def _compile_specialized_tier(self, pending: _PendingSpecialize) -> Any:
        """The route-constant artifact, built with no lock held (on a
        scheduler worker or the caller): on the card the walk with its hops
        baked in, captured as a CUDA graph (an eager warm-up walk, then the
        capture, on the given inputs or zeros of the signature — see
        :class:`~repro_torch.core.interpreter.GraphKernel` for how a worker
        captures while the serving thread runs); on the CPU the walk
        itself.  On a mesh the walk's hops are ring shifts
        (:func:`~repro_torch.core.interpreter.ring_hops`), captured only
        where the group's backend is NCCL, which takes a capture of its
        collectives, and only until :meth:`close`; over gloo the walk runs
        eagerly."""
        kernel = self._store_load_spec(pending)
        if kernel is None:
            donate = cache_lib.kernel_jit_kwargs(pending.jit_kwargs).get("donate_argnums", ())
            kernel = interp.specialize_kernel(pending.graph, pending.hops, donate,
                                              self._hop_fn)
        avals = pending.graph.input_avals()
        cuda = [torch.device(a.device) for a in avals
                if a.device is not None and torch.device(a.device).type == "cuda"]
        if not cuda or (self.mesh is not None and (self.scheduler.closed or dist.get_backend(
                interp.tile_group(self.mesh, self.tile_axis)) != "nccl")):
            return kernel
        with torch.cuda.device(cuda[0]):
            inputs = tuple(x if x is not None else
                           torch.zeros(a.shape, dtype=a.dtype, device=a.device)
                           for x, a in zip(pending.inputs, avals))
            return interp.GraphKernel(kernel, inputs)

    def _store_load_spec(self, pending: _PendingSpecialize
                         ) -> "interp.SpecializedKernel | None":
        """The route-constant walk off disk, if the store holds it for these
        exact hops (a warm boot then skips the build and captures again).
        A mesh overlay reads nothing from the store."""
        if self.store is None or self.mesh is not None:
            return None
        blob = self.store.load_blob(pending.spec_key)
        if blob is None:
            return None
        t0 = time.perf_counter()
        try:
            kernel = BitstreamStore.unpack_kernel(blob)
            if not isinstance(kernel, interp.SpecializedKernel) \
                    or kernel.hops != tuple(pending.hops):
                raise SerialError("not the route-constant walk of these hops")
        except Exception as exc:  # noqa: BLE001 — any failure = cold build
            self.store.note_unusable(pending.spec_key)
            logger.warning("bitstream store: specialized entry for %r failed "
                           "to deserialize (%s); cold compiling",
                           pending.spec_key, exc)
            return None
        dt = time.perf_counter() - t0
        with self._lock:
            self.cache.stats.store_hits += 1
            self.cache.stats.store_load_seconds += dt
        return kernel

    def _commit_specialized(self, pending: _PendingSpecialize, exe: Any,
                            seconds: float) -> Any:
        """Publish a finished route-constant build and swap every live entry
        of the resident onto it, against the EXACT generation it was built
        for: a relocation in flight changed the routes the constants were
        baked from, so the late build is dropped (``dropped_stale``; the
        resident already went back to the generic kernel)."""
        with self._lock:
            if not self.fabric.is_current(pending.rid, pending.generation):
                self.cache.spec_stats.dropped_stale += 1
                cache_lib.release_artifact(exe)
                return None
            res = self.fabric.get(pending.rid)
            self.cache.insert_specialized(pending.spec_key, exe, seconds)
            self.fabric.add_cache_key(pending.rid, pending.key)
            res.tier = "specialized"
            res.spec_pending = False
            res.spec_job = None
            fn = interp.bind_routes(exe, res.routes)
            res.spec_fn = fn
            res.spec_jit_kwargs = pending.jit_kwargs
            for wrapper in list(self._wrappers):
                for entry in list(wrapper._entries.values()):
                    acc = entry.acc
                    if acc is None or acc.resident_id != pending.rid \
                            or acc.generation != res.generation \
                            or entry.jit_kwargs != pending.jit_kwargs:
                        continue
                    entry.record = _DispatchRecord(
                        fn=fn, res=res, generation=res.generation,
                        tier="specialized")
            self._persist_spec_locked(pending, exe)
            self._autotune()
            if self.sanitize:
                self._sanity_check()
            return exe

    def _despecialize(self, res: ResidentAccelerator) -> None:
        """Overlay-side half of despecialization (the caller holds the lock
        and follows up with ``Fabric.relocate``, the one tier-reset point):
        cancel a specialization in flight, drop the resident's
        route-constant artifact and book the despecialization."""
        if res.spec_job is not None:
            self.scheduler.cancel(res.spec_job)
        self._drop_spec_artifacts(res)
        if res.tier == "specialized":
            self.cache.spec_stats.despecializations += 1

    def _drop_spec_artifacts(self, res: ResidentAccelerator) -> None:
        """Drop exactly THIS resident's route-constant artifacts.  Spec keys
        include the hop vector, so a sibling resident sharing the kernel
        key at other routes keeps its own."""
        hops = interp.route_hops(res.graph, res.placement)
        for k in res.cache_keys:
            self.cache.drop_specialized_exact(cache_lib.spec_key(k, hops))

    def _enqueue_contiguous_specializations(self) -> None:
        """Post-defragment hook (the caller holds the lock): with
        ``auto_specialize``, residents whose placement became contiguous
        (pass-through-free) build their route-constant tier, on zeros of
        their signature — on the low lane of an asynchronous overlay,
        inline on a synchronous one."""
        if not self._auto_specialize:
            return
        queue = self.async_downloads
        if queue and self.scheduler.closed:
            return
        for wrapper in list(self._wrappers):
            for entry in list(wrapper._entries.values()):
                acc = entry.acc
                res = self.fabric.get(acc.resident_id) if acc is not None else None
                if res is None or not res.zero_hop:
                    continue
                if queue:
                    self._submit_specialize_locked(entry, res, None)
                else:
                    self._specialize_now(entry, res, None)

    # -- explicit PR-region management ----------------------------------------
    def _evict_resident(self, rid: str, *, drop_store: bool = False) -> int:
        """THE evict path (the caller holds the lock): release a resident's
        tiles, cancel any download, rebind, specialization or persist still
        in flight for it, and drop its specialized artifacts, its route
        programs and the kernel artifacts no surviving resident shares.
        Returns cache entries removed.

        ``drop_store`` also deletes those kernels' store entries: a pressure
        reclaim keeps them (a reclaimed accelerator re-downloading off disk
        is the store's point), an explicit :meth:`evict` means gone, disk
        included."""
        resident = self.fabric.release(rid)
        if resident is None:
            return 0
        # a queued job never runs; a running one loses its right to commit
        # (and the generation guards backstop the race)
        self.scheduler.cancel(rid)
        self.scheduler.cancel(f"relocate:{rid}")
        if resident.spec_job is not None:
            self.scheduler.cancel(resident.spec_job)
        if self.store is not None and resident.cache_keys:
            # in-flight persists must not resurrect the evictee on disk
            # (the _commit_persist liveness guard backstops the race)
            hops = interp.route_hops(resident.graph, resident.placement)
            for k in resident.cache_keys:
                self.scheduler.cancel(f"persist:{k}")
                self.scheduler.cancel(f"persist:{cache_lib.spec_key(k, hops)}")
        # the route-constant tier dies with its resident even when the
        # generic kernel key survives via a sharing sibling
        self._drop_spec_artifacts(resident)
        if resident.tier == "specialized":
            self.cache.spec_stats.despecializations += 1
        self._prefetched.discard(rid)
        self.stats.evictions += 1
        self.cache.evict_routes(rid)
        live_keys = {k for r in self.fabric.residents.values()
                     for k in r.cache_keys}
        removed = self.cache.evict_keys(
            [k for k in resident.cache_keys if k not in live_keys])
        if drop_store and self.store is not None:
            for k in resident.cache_keys:
                if k not in live_keys:
                    self.store.delete(k)
                    self.store.delete_prefix(f"{k}|spec|")
        if self.sanitize:
            self._sanity_check()
        return removed

    def evict(self, target: "Graph | str") -> int:
        """Free one accelerator's PR regions AND its cached bitstreams (by
        graph or name — all resident signatures of that name).  Returns the
        number of cache entries removed."""
        name = target.name if isinstance(target, Graph) else str(target)
        with self._lock:
            removed = 0
            for rid in [r.rid for r in self.fabric.residents.values()
                        if r.name == name]:
                removed += self._evict_resident(rid, drop_store=True)
            # sweep bitstreams with no residency record so evict-by-name
            # stays exhaustive
            removed += self.cache.evict_prefix(f"{name}:")
            if self.store is not None:
                self.store.delete_prefix(f"{name}:")
            return removed

    def reconfigure(self, *, policy: PlacementPolicy | None = None,
                    large_fraction: float | None = None,
                    prefetch: bool = True,
                    relocate: bool = False) -> dict[str, Any]:
        """Full-fabric reconfiguration: flush every resident (tiles AND
        bitstreams; optionally switching placement policy / tile mix), so
        the next assembly re-places and re-downloads.  Cache statistics
        survive the flush.

        ``relocate=True`` instead re-places every movable resident under
        the new policy/grid via relocation — kernels, the cache and the
        download ledger survive.  Residents that no longer fit are evicted
        (the flush would have dropped them too); pinned residents keep
        their tiles.

        Downloads in flight belong to flushed generations: queued ones are
        cancelled and running ones lose their right to commit, so a late
        kernel cannot resurrect a flushed resident.  On an asynchronous
        overlay the flush is followed (unless ``prefetch=False``) by
        downloads for every signature the jit wrappers have seen — the
        fabric rewarms in the background while the fallbacks serve."""
        if relocate:
            return self._reconfigure_relocating(policy, large_fraction)
        with self._lock:
            self.scheduler.flush()
            self._prefetched.clear()
            if policy is not None:
                self.policy = policy
            if large_fraction is not None:
                self.grid = TileGrid(self.grid.rows, self.grid.cols, large_fraction)
            # reset() keeps the generation counter monotonic: handles
            # assembled before the flush never validate against post-flush
            # re-admissions
            flushed = self.fabric.reset(self.grid)
            self.stats.evictions += len(flushed)
            self.cache.clear()
            if self.store is not None:
                # a reconfigure drops what these kernels were placed for:
                # their store entries must not serve a later boot
                for k in {k for r in flushed for k in r.cache_keys}:
                    self.store.delete(k)
                    self.store.delete_prefix(f"{k}|spec|")
            self._last_placement = None
            self.stats.reconfigurations += 1
            if self.async_downloads and prefetch:
                for wrapper in list(self._wrappers):
                    wrapper._prefetch_known()
            if self.sanitize:
                self._sanity_check()
        return self.describe()

    def _reconfigure_relocating(self, policy: PlacementPolicy | None,
                                large_fraction: float | None) -> dict[str, Any]:
        with self._lock:
            if policy is not None:
                self.policy = policy
            if large_fraction is not None:
                self.grid = TileGrid(self.grid.rows, self.grid.cols, large_fraction)
                self.fabric.grid = self.grid

            def evict_and_continue(res: ResidentAccelerator,
                                   exc: PlacementError) -> bool:
                self._evict_resident(res.rid)
                return True

            plan = self._plan_repack(evict_and_continue)
            plan_rids = tuple(res.rid for res, _ in plan)
            for res, pl in plan:
                if pl.assignment != res.placement.assignment \
                        or pl.policy is not res.placement.policy:
                    self._relocate_resident(res.rid, pl, ignore=plan_rids)
            self._last_placement = None
            self.stats.reconfigurations += 1
            if self.sanitize:
                self._sanity_check()
        return self.describe()

    # -- introspection ----------------------------------------------------------
    def describe(self) -> dict[str, Any]:
        return {
            "grid": (self.grid.rows, self.grid.cols),
            "large_tiles": len(self.grid.large_coords()),
            "policy": self.policy.value,
            "cache": dataclasses.asdict(self.cache.stats),
            "cached_bitstreams": len(self.cache),
            "route_programs": self.cache.route_programs(),
            "routes": dataclasses.asdict(self.cache.route_stats),
            "specialization": {
                **dataclasses.asdict(self.cache.spec_stats),
                "specialized_artifacts": self.cache.specialized_count(),
                "auto": self._auto_specialize,
                "specialize_after": self.specialize_after,
            },
            "fabric": self.fabric.describe(),
            "dispatch_latency": self.dispatch_hist.summary(),
            "route_cost": self.route_cost_hist.summary(),
            "assemblies": self.stats.assemblies,
            "reconfigurations": self.stats.reconfigurations,
            "traces": self.stats.traces,
            "trace_seconds": self.stats.trace_seconds,
            "downloads": self.stats.downloads,
            "evictions": self.stats.evictions,
            "reclaims": self.stats.reclaims,
            "defrags": self.stats.defrags,
            "relocations": self.stats.relocations,
            "defrag_failures": self.stats.defrag_failures,
            "async_downloads": self.async_downloads,
            "cost_aware_reclaim": self.cost_aware_reclaim,
            "prefetches": self.stats.prefetches,
            "prefetch_hits": self.stats.prefetch_hits,
            "fallback_calls": self.stats.fallback_calls,
            "stale_downloads": self.stats.stale_downloads,
            "scheduler": self.scheduler.describe(),
            "failures": self.failure_ledger(),
            "faults": self.faults.describe() if self.faults is not None else None,
            "store": self.store.describe() if self.store is not None else None,
            "cost_model_placement": self.cost_model_placement,
            "autotune_thresholds": self.autotune_thresholds,
            "defrag_threshold": round(self.defrag_threshold, 4),
        }


# -----------------------------------------------------------------------------
# Module-level frontend against a process-wide default fabric
# -----------------------------------------------------------------------------
_DEFAULT_OVERLAY: Overlay | None = None


def default_overlay() -> Overlay:
    """The process-wide 3×3 dynamic overlay behind :func:`jit` and
    :func:`jit_assemble` (``repro/core/overlay.py:2302``), made on first use."""
    global _DEFAULT_OVERLAY
    if _DEFAULT_OVERLAY is None:
        _DEFAULT_OVERLAY = Overlay()
    return _DEFAULT_OVERLAY


def jit(fn: Callable[..., Any] | None = None, *,
        overlay: Overlay | None = None, **kwargs) -> Callable[..., Any]:
    """``overlay.jit`` against ``overlay`` or the process default fabric."""
    ov = overlay if overlay is not None else default_overlay()
    if fn is None:
        return lambda f: ov.jit(f, **kwargs)
    return ov.jit(fn, **kwargs)


def jit_assemble(fn: Callable[..., Any] | None = None, **kwargs):
    """Decorator form of the trace frontend::

        @jit_assemble
        def dot(a, b): return torch.sum(a * b)

        @jit_assemble(strict=True, overlay=my_overlay)
        def f(x): ...
    """
    return jit(fn, **kwargs)
