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

A side table holds the third, optional tier: **specialized artifacts**
(:meth:`BitstreamCache.insert_specialized`), keyed by :func:`spec_key` —
a kernel key plus the exact hop vector baked into the artifact.  On the
card such an artifact is a captured CUDA graph of the route-constant walk,
and dropping it releases the graph and its private memory pool.

Below the in-memory levels sits the persistent
:class:`~repro_torch.core.store.BitstreamStore`: a miss it satisfies is
booked by :meth:`BitstreamCache.insert_loaded` (a miss whose download was a
disk load, counted in ``store_hits`` / ``store_load_seconds``).

Port of ``repro/core/cache.py``.
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


def kernel_key(name: str, signature: tuple, fingerprint: str = "",
               extra: str = "", mesh_desc: str = "") -> str:
    """Placement-free identity of a kernel artifact: (graph name, input
    signature, graph content fingerprint, ``extra`` — the jit kwargs the
    kernel honors, such as its donated inputs — and ``mesh_desc``, the mesh
    axis a sharded kernel's hops cross, empty for a local kernel).  Two
    placements of one graph share ONE kernel."""
    if mesh_desc:
        extra = f"{extra}|mesh:{mesh_desc}"
    # no extra: the key of a kernel without jit kwargs stays what it was
    # before donation existed, so existing store entries keep loading
    key = (name, signature, fingerprint, extra) if extra else \
        (name, signature, fingerprint)
    h = hashlib.sha256(repr(key).encode()).hexdigest()[:16]
    return f"{name}:{h}"


def kernel_jit_kwargs(jit_kwargs: "dict[str, Any] | None") -> dict[str, Any]:
    """User-level jit kwargs in the kernel's calling convention: argument 0
    of ``kernel(routes, *inputs)`` is the routes vector, so positional
    argnums (``donate_argnums`` / ``static_argnums``) shift by one — routes
    are never donated or static.  Takes an int or an iterable, as the
    reference does; the name-based ``*_argnames`` forms cannot map onto the
    kernel's signature and are refused."""
    kw = dict(jit_kwargs or {})
    for field in ("donate_argnums", "static_argnums"):
        v = kw.get(field)
        if v is not None:
            if isinstance(v, int):
                v = (v,)
            kw[field] = tuple(i + 1 for i in v)
    if kw.get("donate_argnames") or kw.get("static_argnames"):
        raise ValueError(
            "jit_kwargs *_argnames are not supported on kernel artifacts — "
            "use positional *_argnums")
    return kw


def spec_key(kernel_key: str, hops: "tuple[int, ...]") -> str:
    """Identity of a route-constant specialized artifact: its generic kernel
    key plus the exact hop vector baked into it.  Placements with identical
    hop vectors share one specialized artifact; any other routes make it
    unusable (the generic tier serves instead)."""
    return f"{kernel_key}|spec|{','.join(map(str, hops))}"


def release_artifact(exe: Any) -> None:
    """Free what a dropped specialized artifact holds on the device (a
    captured graph and its memory pool); plain walks hold nothing."""
    release = getattr(exe, "release", None)
    if release is not None:
        release()


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    insertions: int = 0            # entries ever stored
    evictions: int = 0
    compile_seconds: float = 0.0   # total "PR download" time paid
    # persistent-store tier: misses satisfied by a disk load instead of a
    # kernel build, and the time those loads took.  A store hit still counts
    # as a `miss` above (the in-memory cache did miss), so hits keep meaning
    # "served without any download".
    store_hits: int = 0
    store_load_seconds: float = 0.0


@dataclasses.dataclass
class RouteStats:
    """Accounting for the cheap level: per-placement route programs."""

    emitted: int = 0               # route programs built (one per placement)
    hits: int = 0                  # placements served by an existing program
    emit_seconds: float = 0.0      # total route-emission time


@dataclasses.dataclass
class SpecializationStats:
    """Lifecycle accounting for the route-constant specialized tier."""

    specializations: int = 0       # specialized artifacts committed
    despecializations: int = 0     # specialized residents reverted to generic
    specialized_hits: int = 0      # dispatches served by the specialized tier
    dropped_stale: int = 0         # spec commits refused (relocated mid-build)
    compile_seconds: float = 0.0   # specialize (warm-up + capture) time paid


class BitstreamCache:
    """LRU of placement-free kernel artifacts (keyed by :func:`kernel_key`)
    plus a side table of per-placement route programs."""

    def __init__(self, capacity: int = 256) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._store: collections.OrderedDict[str, Any] = collections.OrderedDict()
        self._routes: dict[str, Any] = {}   # "<owner>|<placement>" -> routes
        self._specialized: dict[str, Any] = {}   # spec_key -> artifact
        self.stats = CacheStats()
        self.route_stats = RouteStats()
        self.spec_stats = SpecializationStats()

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
        self._trim()
        return exe

    def _trim(self) -> None:
        if len(self._store) > self.capacity:
            old, _ = self._store.popitem(last=False)
            self.drop_specialized(old)
            self.stats.evictions += 1

    def insert_compiled(self, key: str, exe: Any, compile_seconds: float) -> None:
        """Store a kernel built *outside* the cache (the asynchronous
        pipeline builds on a worker thread, then publishes here).  Books
        what a ``get_or_compile`` miss books: a background download is
        still a download."""
        self.stats.misses += 1
        self.stats.compile_seconds += compile_seconds
        self.put(key, exe)

    def insert_loaded(self, key: str, exe: Any, load_seconds: float) -> None:
        """Store a kernel rebuilt from the persistent bitstream store.
        Booked as a miss (the in-memory cache did miss) whose download cost
        is the load time, which is what teaches the download-cost EWMA that
        this artifact is cheap to bring back (the planner prices reclaims
        off that)."""
        self.stats.misses += 1
        self.stats.compile_seconds += load_seconds
        self.stats.store_hits += 1
        self.stats.store_load_seconds += load_seconds
        self.put(key, exe)

    def put(self, key: str, exe: Any) -> None:
        """Store an artifact built outside :meth:`get_or_compile` (no miss
        is booked; an insertion is, for a new key)."""
        if key not in self._store:
            self.stats.insertions += 1
        self._store[key] = exe
        self._store.move_to_end(key)
        self._trim()

    def peek(self, key: str) -> Any:
        """The stored artifact for ``key`` (or None) without touching LRU
        order or hit/miss statistics — for introspection, not dispatch."""
        return self._store.get(key)

    # -- specialized tier: route-constant artifacts ---------------------------
    def specialized(self, key: str) -> Any:
        """The specialized artifact stored under a :func:`spec_key` (or
        None).  Lookup only — dispatch accounting (``specialized_hits``)
        belongs to the overlay's dispatch records."""
        return self._specialized.get(key)

    def insert_specialized(self, key: str, exe: Any,
                           compile_seconds: float) -> None:
        """Publish a finished route-constant build.  Booked on its own
        ledger: a specialization is an optimization, not a PR download, so
        ``CacheStats`` (misses/compile_seconds) stays untouched."""
        if key not in self._specialized:
            self.spec_stats.specializations += 1
        else:
            release_artifact(self._specialized[key])
        self.spec_stats.compile_seconds += compile_seconds
        self._specialized[key] = exe

    def drop_specialized(self, kernel_key: str) -> int:
        """Drop every specialized variant of one generic kernel artifact —
        for the paths where the kernel key itself dies (eviction of the
        generic entry, LRU replacement, flush).  Returns entries removed."""
        prefix = f"{kernel_key}|spec|"
        doomed = [k for k in self._specialized if k.startswith(prefix)]
        for k in doomed:
            release_artifact(self._specialized.pop(k))
        return len(doomed)

    def drop_specialized_exact(self, key: str) -> int:
        """Drop ONE specialized artifact by its full :func:`spec_key` — for
        despecialization/eviction of a single resident, where a sibling
        resident sharing the kernel key (at other routes) keeps its own
        variant.  Returns entries removed (0 or 1)."""
        exe = self._specialized.pop(key, None)
        if exe is None:
            return 0
        release_artifact(exe)
        return 1

    def drop_all_specialized(self) -> int:
        """Drop every specialized artifact (a mesh overlay's close).
        Returns entries removed."""
        n = len(self._specialized)
        for exe in self._specialized.values():
            release_artifact(exe)
        self._specialized.clear()
        return n

    def specialized_count(self) -> int:
        """Specialized artifacts currently held (introspection)."""
        return len(self._specialized)

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
            # a specialized variant is meaningless without (or beyond the
            # life of) its generic kernel: it dies with the key
            self.drop_specialized(k)
        self.stats.evictions += removed
        return removed

    def evict_prefix(self, prefix: str) -> int:
        """Free all bitstreams whose key starts with ``prefix``."""
        doomed = [k for k in self._store if k.startswith(prefix)]
        for k in doomed:
            del self._store[k]
        for k in [k for k in self._specialized if k.startswith(prefix)]:
            release_artifact(self._specialized.pop(k))
        self.stats.evictions += len(doomed)
        return len(doomed)

    def clear(self) -> None:
        """Drop every entry (both levels).  Stats survive — a flush is an
        eviction event, not amnesia."""
        self.stats.evictions += len(self._store)
        self._store.clear()
        self._routes.clear()
        for exe in self._specialized.values():
            release_artifact(exe)
        self._specialized.clear()
