"""BitstreamCache — the two-level compiled-artifact cache (PR analogue).

The paper's PR regions take ~1.25 ms per bitstream download, "only incurred
at startup or initial configuration" (§III, C3).  In the port a bitstream is
an assembled :class:`~repro_torch.core.interpreter.Kernel` — the graph
flattened into its slot-indexed step list — and a *download* is building it
on a cache miss (see the README's port section).  The cache makes both facts
measurable:

* ``misses`` / ``compile_seconds`` — total configuration overhead paid,
* ``hits``                          — reuse of already-downloaded bitstreams,
* LRU eviction with a capacity     — finite PR-region real estate.

The store is **two-level**, mirroring the paper's relocatable bitstreams:

1. **Kernel artifacts** (the expensive level), keyed by :func:`kernel_key` —
   (graph name, abstract input signature, graph fingerprint), *placement-
   free*.  One artifact serves every placement of a graph; it takes the
   per-edge ``routes`` vector as its first runtime argument.
2. **Route programs** (the cheap level): per-placement hop vectors held in
   a side table (:meth:`BitstreamCache.route_program`), re-emitted in
   microseconds whenever a resident is (re)placed.

Port of ``repro/core/cache.py`` without the specialized tier and the
persistent store, which wait for later slices.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import time
from typing import Any, Callable

from torch.utils import _pytree as pytree


def leaf_signature(a) -> tuple:
    """THE leaf-level abstract signature: ``(shape, dtype, device)``.  One
    definition shared by the cache keys and the jit wrappers' dispatch-path
    entry keys.  Device is part of it because a traced graph bakes the
    device of the tensors it creates."""
    dtype = getattr(a, "dtype", None)
    return (tuple(getattr(a, "shape", ())),
            dtype if dtype is not None else type(a).__name__,
            getattr(a, "device", None))


def signature_of(args: tuple) -> tuple:
    """Abstract signature of concrete/abstract inputs."""
    return tuple(leaf_signature(a) for a in pytree.tree_leaves(args))


def cache_key(name: str, signature: tuple, placement_desc: str = "",
              extra: str = "") -> str:
    h = hashlib.sha256(
        repr((name, signature, placement_desc, extra)).encode()).hexdigest()[:16]
    return f"{name}:{h}"


def kernel_key(name: str, signature: tuple, fingerprint: str = "") -> str:
    """Placement-free identity of a kernel artifact: (graph name, input
    signature, graph content fingerprint).  Two placements of one graph
    share ONE kernel."""
    h = hashlib.sha256(
        repr((name, signature, fingerprint)).encode()).hexdigest()[:16]
    return f"{name}:{h}"


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    insertions: int = 0            # entries ever stored
    evictions: int = 0
    compile_seconds: float = 0.0   # total "PR download" time paid


@dataclasses.dataclass
class RouteStats:
    """Accounting for the cheap level: per-placement route programs."""

    emitted: int = 0               # route programs built (one per placement)
    hits: int = 0                  # placements served by an existing program
    emit_seconds: float = 0.0      # total route-emission time


class BitstreamCache:
    """LRU of placement-free kernel artifacts (keyed by :func:`kernel_key`)
    plus a side table of per-placement route programs."""

    def __init__(self, capacity: int = 256) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._store: collections.OrderedDict[str, Any] = collections.OrderedDict()
        self._routes: dict[str, Any] = {}   # "<owner>|<placement>" -> routes
        self.stats = CacheStats()
        self.route_stats = RouteStats()

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, key: str) -> bool:
        return key in self._store

    def get_or_compile(self, key: str, build: Callable[[], Any]) -> Any:
        """Return the cached artifact for ``key``; on a miss run ``build``
        and time it as PR-download overhead."""
        if key in self._store:
            self._store.move_to_end(key)
            self.stats.hits += 1
            return self._store[key]
        t0 = time.perf_counter()
        exe = build()
        self.stats.compile_seconds += time.perf_counter() - t0
        self.stats.misses += 1
        self.stats.insertions += 1
        self._store[key] = exe
        if len(self._store) > self.capacity:
            self._store.popitem(last=False)
            self.stats.evictions += 1
        return exe

    # -- level 2: per-placement route programs --------------------------------
    def route_program(self, owner: str, placement_desc: str,
                      build: Callable[[], Any]) -> Any:
        """The cheap per-placement artifact for ``owner`` at
        ``placement_desc``; built on first request and timed as route
        emission (NOT download) cost."""
        k = f"{owner}|{placement_desc}"
        if k in self._routes:
            self.route_stats.hits += 1
            return self._routes[k]
        t0 = time.perf_counter()
        routes = build()
        self.route_stats.emit_seconds += time.perf_counter() - t0
        self.route_stats.emitted += 1
        self._routes[k] = routes
        return routes

    def evict_routes(self, owner: str) -> int:
        """Drop every route program owned by ``owner``."""
        doomed = [k for k in self._routes if k.startswith(f"{owner}|")]
        for k in doomed:
            del self._routes[k]
        return len(doomed)

    def route_programs(self) -> int:
        return len(self._routes)

    def evict_keys(self, keys) -> int:
        """Free exactly the given keys (a resident's holdings)."""
        removed = 0
        for k in keys:
            if k in self._store:
                del self._store[k]
                removed += 1
        self.stats.evictions += removed
        return removed

    def evict_prefix(self, prefix: str) -> int:
        """Free all bitstreams whose key starts with ``prefix``."""
        doomed = [k for k in self._store if k.startswith(prefix)]
        for k in doomed:
            del self._store[k]
        self.stats.evictions += len(doomed)
        return len(doomed)

    def clear(self) -> None:
        """Drop every entry (both levels).  Stats survive — a flush is an
        eviction event, not amnesia."""
        self.stats.evictions += len(self._store)
        self._store.clear()
        self._routes.clear()
