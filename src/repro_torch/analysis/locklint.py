"""Concurrency lint for the port's overlay runtime — stdlib ``ast`` only.

The runtime's locking discipline is a handful of prose invariants:
fabric/cache mutation happens under ``Overlay._lock`` (an RLock), a
fleet's routing records under ``FleetOverlay._lock``,
scheduler queues mutate under ``DownloadScheduler._cond``, the bitstream
store's index under ``BitstreamStore._lock``, a fault plan's ledger under
``FaultPlan._lock``, a launch counter under ``LaunchCounter._lock``; the
kernel libraries build under the module lock ``native._build_lock`` and one
CUDA-graph capture runs at a time under ``interpreter._capture_lock``.
Locks are acquired in the fixed order fleet → overlay → {scheduler, store,
fault plan}, and nothing slow (nvcc, a capture, a synchronize, a device-to-host
read, a sleep, a join) runs while a lock is held, except where audited.
This module makes those invariants *executable*: it parses the source tree,
reconstructs which locks are guaranteed held at every statement, and
reports three rules:

``lock-order-cycle``
    The lock-acquisition graph (an edge A→B for every ``with B`` reached
    while A is possibly held, interprocedurally) contains a cycle — two
    threads taking the locks in opposite orders can deadlock.

``unlocked-shared-write``
    A write to a registered shared-mutable attribute (``SHARED_ATTRS``
    below, extensible per class via a ``__locklint_shared__`` class
    attribute) on a path where the owning lock is *not* guaranteed held.

``blocking-call-under-lock``
    A call known to block or burn milliseconds (``BLOCKING_CALLS``) made
    while any lock is guaranteed held.

Locks are attributes assigned a ``threading`` lock in a method
(``self._lock = threading.RLock()`` → ``Class._lock``) and module globals
assigned one (``_build_lock = threading.RLock()`` in ``native.py`` →
``native._build_lock``).

The analysis is deliberately modest but honest about it:

* **must-hold** sets (used by the write + blocking rules) are the
  intersection of the locks held at every *observed* call site, computed
  to a fixed point over the scanned tree — a helper only ever invoked
  under the lock inherits it.  A function with no observed call sites is
  assumed to be a public entry point (nothing held).
* **may-hold** sets (used for lock-order edges) are the union — an edge
  exists if any path can acquire B while holding A.
* ``lambda`` bodies run deferred (scheduler thunks, key functions), so
  they are analyzed with *nothing* held; nested ``def``s are closures
  invoked where they are built, so they inherit the lexical held set at
  their definition site.  A lambda a caller runs at once under its lock
  (a ``get_or_compile`` build callback) is therefore not seen: keep slow work
  out of such lambdas.
* calls through a value the lint cannot type (a kernel walk, a step's
  operator, a wrapper in a module alias) are not followed; their names
  are still checked against ``BLOCKING_CALLS``.
* re-acquiring the same lock class is assumed reentrant (``RLock``) and
  never produces a self-edge; cross-instance ordering within one class
  is not modeled.

The lock-order graph of ``src/repro_torch`` (``lock_graph_summary()``,
held by ``tests/test_torch_analysis.py``)::

    FleetOverlay._lock -> BitstreamStore._lock
    FleetOverlay._lock -> DownloadScheduler._cond
    FleetOverlay._lock -> FaultPlan._lock
    FleetOverlay._lock -> Overlay._lock
    Overlay._lock -> BitstreamStore._lock
    Overlay._lock -> DownloadScheduler._cond

The fleet lock is held while a rebalance or a member's death downloads
through a member (a replica on the low lane, an evacuation), which takes
that member's lock and, below it, the scheduler's, the store's and the
fault plan's.  Nothing under a member's lock takes the fleet lock (a
member's ``reclaim_prefer`` reads the fleet's records without it).  Every
other lock (``LaunchCounter._lock``, ``interpreter._capture_lock``,
``interpreter._builds_lock``, ``native._build_lock``) is taken with no
other lock of the tree held and takes none itself; no edge leaves a leaf,
so there is no cycle.

Audited, deliberate exceptions live in an allowlist file of exact
fingerprints (``rule:path:Class.method:detail``; the file may hold fnmatch
patterns, but the port's names single sites), each with its audit — the
lint is zero-noise on a clean tree and any new finding is a regression.

Run: ``PYTHONPATH=src python -m repro_torch.analysis.locklint src/repro_torch``

Port of ``repro/analysis/locklint.py`` (stdlib-only there too); the port
keeps its own copy, with module-level locks and the port's registries.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import fnmatch
import json
import os
import sys
from collections import defaultdict
from typing import Any

__all__ = ["Finding", "LockLint", "main", "run", "DEFAULT_ALLOWLIST",
           "SHARED_ATTRS", "BLOCKING_CALLS"]

# threading factory callables whose assignment to ``self.X`` registers X as
# a lock attribute of the enclosing class
_LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore",
                   "BoundedSemaphore"}

# Shared-mutable attribute registry: class name -> {attr -> owning lock id}.
# A write to one of these outside the owner lock is a finding.  Attributes
# that are *deliberately* mutated lock-free on the dispatch fast path
# (recency ticks, routing estimates, single-reference record republish)
# are still registered — their audited sites live in the allowlist, so any
# NEW lock-free write site is caught.
SHARED_ATTRS: dict[str, dict[str, str]] = {
    "Fabric": {
        "_residents": "Overlay._lock",
        "_tick": "Overlay._lock",
        "_generation": "Overlay._lock",
        "_download_counts": "Overlay._lock",
        "_download_costs": "Overlay._lock",
        "_dispatch_states": "Overlay._lock",
    },
    "ResidentAccelerator": {
        "tiles": "Overlay._lock",
        "placement": "Overlay._lock",
        "program": "Overlay._lock",
        "generation": "Overlay._lock",
        "live": "Overlay._lock",
        "tier": "Overlay._lock",
        "routes": "Overlay._lock",
        "cache_keys": "Overlay._lock",
        "spec_fn": "Overlay._lock",
        "spec_pending": "Overlay._lock",
        "spec_job": "Overlay._lock",
        "acc": "Overlay._lock",
        "occupants": "Overlay._lock",
    },
    "BitstreamCache": {
        "_store": "Overlay._lock",
        "_routes": "Overlay._lock",
        "_specialized": "Overlay._lock",
    },
    "Overlay": {
        "_prefetched": "Overlay._lock",
        "_last_placement": "Overlay._lock",
    },
    "_JitEntry": {
        "record": "Overlay._lock",
    },
    "DownloadScheduler": {
        "_queue": "DownloadScheduler._cond",
        "_low": "DownloadScheduler._cond",
        "_jobs": "DownloadScheduler._cond",
        "_finishing": "DownloadScheduler._cond",
        "_shutdown": "DownloadScheduler._cond",
        "_threads": "DownloadScheduler._cond",
    },
    "FleetOverlay": {
        "_window_routed": "FleetOverlay._lock",
        "_graph_homes": "FleetOverlay._lock",
    },
    "FleetJitAssembled": {
        "_records": "FleetOverlay._lock",
    },
    "_FleetRecord": {
        "replicas": "FleetOverlay._lock",
    },
    "FaultPlan": {
        "_counts": "FaultPlan._lock",
        "_events": "FaultPlan._lock",
        "_killed": "FaultPlan._lock",
    },
    "LaunchCounter": {
        "count": "LaunchCounter._lock",
        "by_variant": "LaunchCounter._lock",
    },
}

# callee names (the final attribute/function name) that block or burn
# milliseconds — forbidden while any lock is guaranteed held:
#   sleep, wait, join, drain       — waiting on time or on other threads
#   synchronize, item, tolist, cpu — the host waits for the card
#   Popen, communicate             — nvcc (kernels/native.py builds with it)
#   capture_begin, capture_end     — a CUDA-graph capture (a warm-up walk and
#                                    the capture of a whole decode step)
#   build_kernel, specialize_kernel, unpack_kernel, pack_kernel — a kernel
#                                    build or its serial form: the port's
#                                    counterpart of the reference's compiles
BLOCKING_CALLS = {
    "sleep", "wait", "join", "drain",
    "synchronize", "item", "tolist", "cpu",
    "Popen", "communicate",
    "capture_begin", "capture_end",
    "build_kernel", "specialize_kernel", "unpack_kernel", "pack_kernel",
}

# container constructors that pass their first argument's type through
_PASSTHROUGH_CALLS = {"list", "tuple", "set", "frozenset", "sorted",
                      "reversed"}
# callables returning one *element* of their first argument
_ELEMENT_CALLS = {"min", "max", "next"}

DEFAULT_ALLOWLIST = os.path.join(os.path.dirname(__file__),
                                 "locklint_allow.txt")


def _is_lock_factory(value: ast.AST) -> bool:
    """``threading.Lock()`` / ``RLock()`` / ... as an assigned value."""
    if not isinstance(value, ast.Call):
        return False
    f = value.func
    name = (f.attr if isinstance(f, ast.Attribute)
            else f.id if isinstance(f, ast.Name) else None)
    return name in _LOCK_FACTORIES


# ---------------------------------------------------------------------------
# findings
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    qualname: str
    detail: str
    message: str

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}:{self.path}:{self.qualname}:{self.detail}"

    def render(self) -> str:
        return (f"{self.path}:{self.line}: {self.rule} in {self.qualname}: "
                f"{self.message}")


# ---------------------------------------------------------------------------
# type-string helpers ("Overlay", "list[Overlay]", "dict[str, Resident]")
# ---------------------------------------------------------------------------
def _ann_to_type(node: ast.AST | None) -> str | None:
    """Render an annotation expression to a plain type string (quoted
    annotations are parsed; ``X | None``/``Optional[X]`` unwrap to X)."""
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        try:
            node = ast.parse(node.value, mode="eval").body
        except SyntaxError:
            return None
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr):
        left = _ann_to_type(node.left)
        right = _ann_to_type(node.right)
        if right in (None, "None"):
            return left
        if left in (None, "None"):
            return right
        return None                      # genuinely polymorphic: give up
    if isinstance(node, ast.Subscript):
        base = _ann_to_type(node.value)
        if base is None:
            return None
        if base == "Optional":
            return _ann_to_type(node.slice)
        args = node.slice
        parts = (args.elts if isinstance(args, ast.Tuple) else [args])
        inner = [_ann_to_type(p) or "?" for p in parts]
        return f"{base}[{', '.join(inner)}]"
    return None


def _container_parts(t: str | None) -> tuple[str, list[str]] | None:
    if not t or "[" not in t or not t.endswith("]"):
        return None
    base, _, rest = t.partition("[")
    inner = rest[:-1]
    parts, depth, cur = [], 0, ""
    for ch in inner:
        if ch == "," and depth == 0:
            parts.append(cur.strip())
            cur = ""
        else:
            depth += ch == "["
            depth -= ch == "]"
            cur += ch
    parts.append(cur.strip())
    return base, parts


def _element_type(t: str | None) -> str | None:
    """The element type an iteration/index over ``t`` yields."""
    cp = _container_parts(t)
    if cp is None:
        return None
    base, parts = cp
    base = base.rsplit(".", 1)[-1]
    if base in ("dict", "OrderedDict", "defaultdict", "Mapping"):
        return parts[0] if parts else None          # iteration -> keys
    return parts[0] if parts else None


def _value_type(t: str | None) -> str | None:
    """The value type of a mapping ``t`` (``.get``/``.values``/index)."""
    cp = _container_parts(t)
    if cp is None:
        return None
    base, parts = cp
    base = base.rsplit(".", 1)[-1]
    if base in ("dict", "OrderedDict", "defaultdict", "Mapping") \
            and len(parts) >= 2:
        return parts[-1]
    return parts[0] if parts else None


# ---------------------------------------------------------------------------
# model of the scanned tree
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class FuncInfo:
    qualname: str
    path: str
    node: ast.AST                        # FunctionDef / AsyncFunctionDef
    cls: "ClassInfo | None"
    param_types: dict[str, str]
    return_type: str | None
    is_property: bool = False
    # fixed-point state
    entry_must: frozenset = frozenset()
    entry_may: frozenset = frozenset()
    callsites_must: list = dataclasses.field(default_factory=list)
    callsites_may: list = dataclasses.field(default_factory=list)
    lexical_entry: frozenset | None = None   # nested defs: inherited held


@dataclasses.dataclass
class ClassInfo:
    name: str
    path: str
    locks: set[str] = dataclasses.field(default_factory=set)
    attr_types: dict[str, str] = dataclasses.field(default_factory=dict)
    methods: dict[str, FuncInfo] = dataclasses.field(default_factory=dict)
    shared: dict[str, str] = dataclasses.field(default_factory=dict)


class LockLint:
    """One lint run over a set of files."""

    def __init__(self, files: list[str], *,
                 shared_attrs: dict[str, dict[str, str]] | None = None
                 ) -> None:
        self.files = files
        self.classes: dict[str, ClassInfo] = {}
        self.module_funcs: dict[str, FuncInfo] = {}
        # path -> {name -> FuncInfo}: module functions by defining file, and
        # the names each file imports with ``from ... import``
        self.funcs_by_path: dict[str, dict[str, FuncInfo]] = {}
        self.imported: dict[str, set[str]] = {}
        self.shared = {c: dict(a) for c, a in
                       (shared_attrs or SHARED_ATTRS).items()}
        self.findings: list[Finding] = []
        # lock-order graph: edge (A, B) -> first (path, line) that creates it
        self.edges: dict[tuple[str, str], tuple[str, int]] = {}
        self._trees: dict[str, ast.Module] = {}
        # path -> {global name -> lock id} for module-level locks
        self.module_locks: dict[str, dict[str, str]] = {}
        self._emit = False

    # -- pass 1: collect classes, locks, attribute types, functions ----------
    def load(self) -> None:
        for path in self.files:
            try:
                with open(path, encoding="utf-8") as fh:
                    tree = ast.parse(fh.read(), filename=path)
            except (OSError, SyntaxError) as exc:
                self.findings.append(Finding(
                    "parse-error", path, 1, "<module>", "parse",
                    f"could not parse: {exc}"))
                continue
            self._trees[path] = tree
            stem = os.path.splitext(os.path.basename(path))[0]
            for node in tree.body:
                if isinstance(node, ast.Assign) and _is_lock_factory(node.value):
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            self.module_locks.setdefault(path, {})[tgt.id] = \
                                f"{stem}.{tgt.id}"
                if isinstance(node, ast.ClassDef):
                    self._collect_class(path, node)
                elif isinstance(node, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    info = self._func_info(path, node, None, node.name)
                    self.module_funcs[node.name] = info
                    self.funcs_by_path.setdefault(path, {})[node.name] = info
            self.imported[path] = {a.asname or a.name for n in ast.walk(tree)
                                   if isinstance(n, ast.ImportFrom)
                                   for a in n.names}

    def _func_info(self, path: str, node, cls: ClassInfo | None,
                   qualname: str) -> FuncInfo:
        params: dict[str, str] = {}
        args = node.args
        for a in (args.posonlyargs + args.args + args.kwonlyargs):
            t = _ann_to_type(a.annotation)
            if t:
                params[a.arg] = t
        is_prop = any(isinstance(d, ast.Name) and d.id == "property"
                      for d in node.decorator_list)
        return FuncInfo(qualname=qualname, path=path, node=node, cls=cls,
                        param_types=params,
                        return_type=_ann_to_type(node.returns),
                        is_property=is_prop)

    def _collect_class(self, path: str, node: ast.ClassDef) -> None:
        info = self.classes.setdefault(node.name,
                                       ClassInfo(node.name, path))
        info.shared.update(self.shared.get(node.name, {}))
        for stmt in node.body:
            if isinstance(stmt, ast.AnnAssign) and \
                    isinstance(stmt.target, ast.Name):
                t = _ann_to_type(stmt.annotation)
                if t:
                    info.attr_types[stmt.target.id] = t
            elif isinstance(stmt, ast.Assign):
                for tgt in stmt.targets:
                    if isinstance(tgt, ast.Name) and \
                            tgt.id == "__locklint_shared__" and \
                            isinstance(stmt.value, ast.Dict):
                        for k, v in zip(stmt.value.keys, stmt.value.values):
                            if isinstance(k, ast.Constant) and \
                                    isinstance(v, ast.Constant):
                                info.shared[str(k.value)] = str(v.value)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                info.methods[stmt.name] = self._func_info(
                    path, stmt, info, f"{node.name}.{stmt.name}")
                self._collect_self_attrs(info, stmt)

    def _collect_self_attrs(self, info: ClassInfo, fn) -> None:
        params = {a.arg: _ann_to_type(a.annotation)
                  for a in (fn.args.posonlyargs + fn.args.args
                            + fn.args.kwonlyargs)}
        for node in ast.walk(fn):
            tgt = None
            value = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt, value = node.targets[0], node.value
            elif isinstance(node, ast.AnnAssign):
                tgt, value = node.target, node.value
                if isinstance(tgt, ast.Attribute) and \
                        isinstance(tgt.value, ast.Name) and \
                        tgt.value.id == "self":
                    t = _ann_to_type(node.annotation)
                    if t:
                        info.attr_types.setdefault(tgt.attr, t)
                    continue
            if not (isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"):
                continue
            # self.X = threading.RLock()  ->  lock attribute
            if isinstance(value, ast.Call):
                fname = value.func
                name = (fname.attr if isinstance(fname, ast.Attribute)
                        else fname.id if isinstance(fname, ast.Name)
                        else None)
                if name in _LOCK_FACTORIES:
                    info.locks.add(tgt.attr)
                    continue
                if name in self.classes or name and name[:1].isupper():
                    info.attr_types.setdefault(tgt.attr, name or "")
                    continue
            # self.X = param  ->  X: type(param)
            if isinstance(value, ast.Name) and params.get(value.id):
                info.attr_types.setdefault(tgt.attr, params[value.id])

    # -- expression type inference -------------------------------------------
    def _infer(self, node: ast.AST, env: dict[str, str],
               fn: FuncInfo) -> str | None:
        if isinstance(node, ast.Name):
            if node.id == "self" and fn.cls is not None:
                return fn.cls.name
            return env.get(node.id) or fn.param_types.get(node.id)
        if isinstance(node, ast.Attribute):
            base = self._infer(node.value, env, fn)
            return self._attr_type(base, node.attr)
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name):
                if f.id in self.classes:
                    return f.id
                if f.id in _PASSTHROUGH_CALLS and node.args:
                    return self._infer(node.args[0], env, fn)
                if f.id in _ELEMENT_CALLS and node.args:
                    return _element_type(self._infer(node.args[0], env, fn))
                mf = self._module_func(f.id, env, fn)
                return mf.return_type if mf is not None else None
            if isinstance(f, ast.Attribute):
                base = self._infer(f.value, env, fn)
                if base is not None:
                    cp = _container_parts(base)
                    if cp is not None:      # container method
                        if f.attr in ("values",):
                            v = _value_type(base)
                            return f"list[{v}]" if v else None
                        if f.attr in ("get", "pop", "popleft", "popitem",
                                      "setdefault"):
                            return _value_type(base)
                        return None
                    m = self._method(base, f.attr)
                    return m.return_type if m is not None else None
            return None
        if isinstance(node, ast.Subscript):
            base = self._infer(node.value, env, fn)
            if isinstance(node.slice, ast.Slice):
                return base                  # a slice keeps the container
            return _value_type(base)
        if isinstance(node, (ast.ListComp, ast.GeneratorExp, ast.SetComp)):
            comp_env = dict(env)
            for gen in node.generators:
                self._bind_target(gen.target,
                                  _element_type(self._infer(gen.iter,
                                                            comp_env, fn)),
                                  comp_env)
            elt = self._infer(node.elt, comp_env, fn)
            return f"list[{elt}]" if elt else None
        if isinstance(node, ast.IfExp):
            return (self._infer(node.body, env, fn)
                    or self._infer(node.orelse, env, fn))
        if isinstance(node, ast.BoolOp):
            for v in node.values:
                t = self._infer(v, env, fn)
                if t:
                    return t
        return None

    def _module_func(self, name: str, env: dict[str, str],
                     fn: FuncInfo) -> FuncInfo | None:
        """The module function a bare-name call reaches: one defined in the
        caller's file, else one the file imports by name.  A parameter or a
        local of that name shadows both (``build()`` on a callable argument
        is not ``native.build``)."""
        args = fn.node.args
        if name in env or name in {a.arg for a in (args.posonlyargs + args.args
                                                   + args.kwonlyargs)}:
            return None
        own = self.funcs_by_path.get(fn.path, {}).get(name)
        if own is not None:
            return own
        if name in self.imported.get(fn.path, ()):
            return self.module_funcs.get(name)
        return None

    def _attr_type(self, base: str | None, attr: str) -> str | None:
        if base is None:
            return None
        cls = self.classes.get(base.rsplit(".", 1)[-1])
        if cls is None:
            return None
        t = cls.attr_types.get(attr)
        if t:
            return t
        m = cls.methods.get(attr)
        if m is not None and m.is_property:
            return m.return_type
        return None

    def _method(self, base: str | None, name: str) -> FuncInfo | None:
        if base is None:
            return None
        cls = self.classes.get(base.rsplit(".", 1)[-1])
        if cls is None:
            return None
        return cls.methods.get(name)

    def _bind_target(self, target: ast.AST, t: str | None,
                     env: dict[str, str]) -> None:
        if t is None:
            return
        if isinstance(target, ast.Name):
            env[target.id] = t

    # -- lock expression resolution ------------------------------------------
    def _resolve_lock(self, node: ast.AST, env: dict[str, str],
                      fn: FuncInfo) -> str | None:
        """``expr`` names a known lock?  Returns ``Class._attr``,
        ``module._name`` or None."""
        if isinstance(node, ast.Name) and node.id not in env:
            return self.module_locks.get(fn.path, {}).get(node.id)
        if isinstance(node, ast.Attribute):
            base = self._infer(node.value, env, fn)
            if base is not None:
                cls = self.classes.get(base.rsplit(".", 1)[-1])
                if cls is not None and node.attr in cls.locks:
                    return f"{cls.name}.{node.attr}"
        return None

    # -- the walk -------------------------------------------------------------
    def analyze(self, passes: int = 40) -> list[Finding]:
        self.load()
        funcs = list(self.module_funcs.values())
        for cls in self.classes.values():
            funcs.extend(cls.methods.values())
        # fixed point: optimistic top for must (narrowing), bottom for may
        all_locks = frozenset(
            [f"{c.name}.{a}" for c in self.classes.values() for a in c.locks]
            + [lk for m in self.module_locks.values() for lk in m.values()])
        for f in funcs:
            f.entry_must = all_locks
            f.entry_may = frozenset()
        for _ in range(max(2, passes)):
            for f in funcs:
                f.callsites_must = []
                f.callsites_may = []
            for f in funcs:
                self._walk_function(f)
            changed = False
            for f in funcs:
                must = (frozenset.intersection(*map(frozenset,
                                                    f.callsites_must))
                        if f.callsites_must else frozenset())
                may = frozenset().union(*map(frozenset, f.callsites_may)) \
                    if f.callsites_may else frozenset()
                if f.lexical_entry is not None:
                    must = must | f.lexical_entry if f.callsites_must \
                        else f.lexical_entry
                    may = may | f.lexical_entry
                if must != f.entry_must or may != f.entry_may:
                    changed = True
                f.entry_must, f.entry_may = must, may
            if not changed:
                break
        # emit pass
        self._emit = True
        self.edges.clear()
        for f in funcs:
            self._walk_function(f)
        self._find_cycles()
        self.findings.sort(key=lambda f: (f.path, f.line, f.rule))
        return self.findings

    def _walk_function(self, fn: FuncInfo) -> None:
        env: dict[str, str] = {}
        self._walk_body(fn.node.body, frozenset(fn.entry_must),
                        frozenset(fn.entry_may | fn.entry_must), env, fn)

    def _walk_body(self, stmts, must: frozenset, may: frozenset,
                   env: dict[str, str], fn: FuncInfo) -> None:
        for stmt in stmts:
            self._walk_stmt(stmt, must, may, env, fn)

    def _walk_stmt(self, node, must, may, env, fn: FuncInfo) -> None:
        if isinstance(node, ast.With):
            acquired: list[str] = []
            for item in node.items:
                self._scan_expr(item.context_expr, must, may, env, fn)
                lock = self._resolve_lock(item.context_expr, env, fn)
                if lock is not None:
                    if self._emit:
                        for held in may | frozenset(acquired):
                            if held != lock:
                                self.edges.setdefault(
                                    (held, lock),
                                    (fn.path, node.lineno))
                    acquired.append(lock)
            self._walk_body(node.body, must | frozenset(acquired),
                            may | frozenset(acquired), env, fn)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a nested def is a closure invoked where it is built: it
            # inherits the lexical held set at its definition site
            sub = self._func_info(fn.path, node, fn.cls,
                                  f"{fn.qualname}.{node.name}")
            sub.entry_must, sub.entry_may = must, may
            self._walk_function(sub)
            return
        if isinstance(node, ast.Assign):
            self._scan_expr(node.value, must, may, env, fn)
            for tgt in node.targets:
                self._check_write(tgt, must, env, fn)
            if len(node.targets) == 1:
                self._bind_target(node.targets[0],
                                  self._infer(node.value, env, fn), env)
            return
        if isinstance(node, ast.AnnAssign):
            if node.value is not None:
                self._scan_expr(node.value, must, may, env, fn)
            self._check_write(node.target, must, env, fn)
            if isinstance(node.target, ast.Name):
                t = _ann_to_type(node.annotation)
                if t:
                    env[node.target.id] = t
            return
        if isinstance(node, ast.AugAssign):
            self._scan_expr(node.value, must, may, env, fn)
            self._check_write(node.target, must, env, fn)
            return
        if isinstance(node, ast.Delete):
            for tgt in node.targets:
                self._check_write(tgt, must, env, fn)
            return
        if isinstance(node, ast.For):
            self._scan_expr(node.iter, must, may, env, fn)
            self._bind_target(node.target,
                              _element_type(self._infer(node.iter, env, fn)),
                              env)
            self._walk_body(node.body, must, may, env, fn)
            self._walk_body(node.orelse, must, may, env, fn)
            return
        if isinstance(node, (ast.If, ast.While)):
            self._scan_expr(node.test, must, may, env, fn)
            self._walk_body(node.body, must, may, env, fn)
            self._walk_body(node.orelse, must, may, env, fn)
            return
        if isinstance(node, ast.Try):
            self._walk_body(node.body, must, may, env, fn)
            for h in node.handlers:
                self._walk_body(h.body, must, may, env, fn)
            self._walk_body(node.orelse, must, may, env, fn)
            self._walk_body(node.finalbody, must, may, env, fn)
            return
        if isinstance(node, ast.Return):
            if node.value is not None:
                self._scan_expr(node.value, must, may, env, fn)
            return
        if isinstance(node, ast.Expr):
            self._scan_expr(node.value, must, may, env, fn)
            return
        # anything else: scan embedded expressions generically
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._scan_expr(child, must, may, env, fn)
            elif isinstance(child, ast.stmt):
                self._walk_stmt(child, must, may, env, fn)

    # -- expression scanning (calls + lambdas) --------------------------------
    def _scan_expr(self, node, must, may, env, fn: FuncInfo) -> None:
        if node is None:
            return
        if isinstance(node, ast.Lambda):
            # deferred execution (scheduler thunks, sort keys): nothing held
            self._scan_expr(node.body, frozenset(), frozenset(), env, fn)
            return
        if isinstance(node, ast.Call):
            self._handle_call(node, must, may, env, fn)
            self._scan_expr(node.func if isinstance(node.func, ast.Call)
                            else None, must, may, env, fn)
            if isinstance(node.func, ast.Attribute):
                self._scan_expr(node.func.value, must, may, env, fn)
            for a in node.args:
                self._scan_expr(a, must, may, env, fn)
            for kw in node.keywords:
                self._scan_expr(kw.value, must, may, env, fn)
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._scan_expr(child, must, may, env, fn)
            elif isinstance(child, (ast.comprehension,)):
                self._scan_expr(child.iter, must, may, env, fn)
                for cond in child.ifs:
                    self._scan_expr(cond, must, may, env, fn)

    def _handle_call(self, node: ast.Call, must, may, env,
                     fn: FuncInfo) -> None:
        if self._emit:
            self._check_mutator(node, must, env, fn)
        f = node.func
        callee_name = (f.attr if isinstance(f, ast.Attribute)
                       else f.id if isinstance(f, ast.Name) else None)
        target: FuncInfo | None = None
        if isinstance(f, ast.Attribute):
            base = self._infer(f.value, env, fn)
            target = self._method(base, f.attr)
        elif isinstance(f, ast.Name):
            target = self._module_func(f.id, env, fn)
        if target is not None:
            target.callsites_must.append(must)
            target.callsites_may.append(may)
        elif callee_name in BLOCKING_CALLS and must:
            # unresolved + blocking name: skip str.join on literals, and
            # calls on the lock itself (Condition.wait releases the lock)
            recv_is_literal = (isinstance(f, ast.Attribute) and
                               isinstance(f.value, ast.Constant))
            recv_is_lock = (isinstance(f, ast.Attribute) and
                            self._resolve_lock(f.value, env, fn) is not None)
            if not recv_is_lock and not recv_is_literal and self._emit:
                self.findings.append(Finding(
                    "blocking-call-under-lock", fn.path, node.lineno,
                    fn.qualname, callee_name,
                    f"blocking call {callee_name}() while holding "
                    f"{', '.join(sorted(must))}"))

    # -- rule: unlocked shared write ------------------------------------------
    _MUTATORS = {"append", "appendleft", "add", "discard", "remove", "pop",
                 "popleft", "popitem", "clear", "update", "extend", "insert",
                 "setdefault", "move_to_end", "__setitem__"}

    def _check_write(self, target, must, env, fn: FuncInfo) -> None:
        if not self._emit:
            return
        if fn.node.name in ("__init__", "__post_init__"):
            return                       # construction precedes sharing
        attr_node = None
        if isinstance(target, ast.Attribute):
            attr_node = target
        elif isinstance(target, ast.Subscript) and \
                isinstance(target.value, ast.Attribute):
            attr_node = target.value
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._check_write(el, must, env, fn)
            return
        if attr_node is None:
            return
        base = self._infer(attr_node.value, env, fn)
        self._report_shared_write(base, attr_node.attr, must, fn,
                                  attr_node.lineno)

    def _report_shared_write(self, base, attr, must, fn: FuncInfo,
                             line: int) -> None:
        if base is None:
            return
        cls = self.classes.get(base.rsplit(".", 1)[-1])
        if cls is None:
            return
        owner = cls.shared.get(attr) or \
            self.shared.get(cls.name, {}).get(attr)
        if owner is None or owner in must:
            return
        self.findings.append(Finding(
            "unlocked-shared-write", fn.path, line, fn.qualname,
            f"{cls.name}.{attr}",
            f"write to {cls.name}.{attr} without holding {owner} "
            f"(held: {', '.join(sorted(must)) or 'nothing'})"))

    # -- rule: mutator-method writes (x.attr.append(...)) ---------------------
    # a mutator on a shared container is a call whose func is
    # Attribute(Attribute(recv, shared_attr), mutator)
    def _check_mutator(self, node: ast.Call, must, env,
                       fn: FuncInfo) -> None:
        f = node.func
        if not (isinstance(f, ast.Attribute) and f.attr in self._MUTATORS
                and isinstance(f.value, ast.Attribute)):
            return
        if fn.node.name in ("__init__", "__post_init__"):
            return
        base = self._infer(f.value.value, env, fn)
        self._report_shared_write(base, f.value.attr, must, fn, node.lineno)

    # -- rule: lock-order cycles ----------------------------------------------
    def _find_cycles(self) -> None:
        graph: dict[str, set[str]] = defaultdict(set)
        for a, b in self.edges:
            graph[a].add(b)
        seen: set[frozenset] = set()
        for start in sorted(graph):
            path: list[str] = []
            on_path: set[str] = set()

            def dfs(nde: str) -> None:
                if nde in on_path:
                    cyc = path[path.index(nde):]
                    key = frozenset(cyc)
                    if key not in seen:
                        seen.add(key)
                        site = self.edges.get(
                            (cyc[-1], cyc[0]),
                            self.edges.get((cyc[0], cyc[1 % len(cyc)]),
                                           ("<graph>", 0)))
                        detail = "->".join(cyc + [cyc[0]])
                        self.findings.append(Finding(
                            "lock-order-cycle", site[0], site[1],
                            "<lock-graph>", detail,
                            f"deadlock-capable acquisition cycle {detail}"))
                    return
                on_path.add(nde)
                path.append(nde)
                for nxt in sorted(graph.get(nde, ())):
                    dfs(nxt)
                path.pop()
                on_path.discard(nde)

            dfs(start)

    def lock_graph_summary(self) -> dict[str, Any]:
        locks = sorted([f"{c.name}.{a}" for c in self.classes.values()
                        for a in c.locks]
                       + [lk for m in self.module_locks.values()
                          for lk in m.values()])
        return {
            "locks": locks,
            "edges": sorted(f"{a} -> {b}" for a, b in self.edges),
            "classes": len(self.classes),
            "files": len(self._trees),
        }


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------
def _collect_files(paths: list[str]) -> list[str]:
    out: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, names in os.walk(p):
                out.extend(os.path.join(root, n) for n in sorted(names)
                           if n.endswith(".py"))
        elif p.endswith(".py"):
            out.append(p)
    return [os.path.relpath(f).replace(os.sep, "/") for f in sorted(set(out))]


def _load_allowlist(path: str | None) -> list[str]:
    if not path or not os.path.exists(path):
        return []
    patterns = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line and not line.startswith("#"):
                patterns.append(line)
    return patterns


def _allowlisted(finding: Finding, patterns: list[str]) -> bool:
    return any(fnmatch.fnmatch(finding.fingerprint, p) for p in patterns)


def run(paths: list[str], *, allowlist: str | None = DEFAULT_ALLOWLIST
        ) -> tuple[list[Finding], list[Finding], LockLint]:
    """Lint ``paths``; returns (unallowlisted, allowlisted, lint)."""
    lint = LockLint(_collect_files(paths))
    findings = lint.analyze()
    patterns = _load_allowlist(allowlist)
    kept = [f for f in findings if not _allowlisted(f, patterns)]
    waived = [f for f in findings if _allowlisted(f, patterns)]
    return kept, waived, lint


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis.locklint",
        description="Concurrency lint for the overlay runtime")
    ap.add_argument("paths", nargs="+", help="files or directories to lint")
    ap.add_argument("--allowlist", default=DEFAULT_ALLOWLIST,
                    help="fnmatch patterns over finding fingerprints")
    ap.add_argument("--no-allowlist", action="store_true",
                    help="report audited findings too")
    ap.add_argument("--json", action="store_true", dest="as_json")
    ap.add_argument("--expect-rules", default=None,
                    help="comma-separated rules that MUST all fire "
                         "(fixture self-test); exits 0 iff every one does")
    args = ap.parse_args(argv)

    allow = None if (args.no_allowlist or args.expect_rules) \
        else args.allowlist
    kept, waived, lint = run(args.paths, allowlist=allow)

    if args.expect_rules:
        wanted = {r.strip() for r in args.expect_rules.split(",") if r.strip()}
        fired = {f.rule for f in kept}
        missing = sorted(wanted - fired)
        for f in kept:
            print(f.render())
        if missing:
            print(f"MISSING expected rules: {', '.join(missing)}",
                  file=sys.stderr)
            return 1
        print(f"all expected rules fired: {', '.join(sorted(wanted))}")
        return 0

    if args.as_json:
        print(json.dumps({
            "findings": [dataclasses.asdict(f) for f in kept],
            "allowlisted": [f.fingerprint for f in waived],
            "lock_graph": lint.lock_graph_summary(),
        }, indent=2))
    else:
        for f in kept:
            print(f.render())
            print(f"    fingerprint: {f.fingerprint}")
        g = lint.lock_graph_summary()
        print(f"{len(kept)} finding(s), {len(waived)} allowlisted; "
              f"{len(g['locks'])} lock(s), {len(g['edges'])} order edge(s) "
              f"across {g['files']} file(s)")
    return 1 if kept else 0


if __name__ == "__main__":
    raise SystemExit(main())
