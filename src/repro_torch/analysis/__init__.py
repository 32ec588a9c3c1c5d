"""Verification tooling for the port's overlay runtime.

Three parts:

* :mod:`repro_torch.analysis.locklint` — AST concurrency lint (lock-order
  cycles, unlocked shared writes, blocking calls under a lock) over
  ``src/repro_torch``.
* :mod:`repro_torch.analysis.check` — pure invariant checkers for the
  fabric ledger, the residents' routes and tiers, the cache's side tables,
  the circuit breakers, a fleet's replica records and member health, and
  the ``describe()`` schemas of an overlay and a fleet.
* the sanitizer — ``Overlay(sanitize=True)`` / ``REPRO_SANITIZE=1`` runs
  the checkers at every mutation edge and raises
  :class:`repro_torch.analysis.check.InvariantError` on the first
  violation.

``python -m repro_torch.analysis report`` runs all of it.  This package is
import-light on purpose: ``locklint`` is stdlib-only, and ``check`` only
touches runtime objects handed to it.  Submodules load lazily.

Port of ``repro/analysis/``.
"""

from __future__ import annotations

from typing import Any

__all__ = ["check", "locklint", "InvariantError"]


def __getattr__(name: str) -> Any:
    if name in ("check", "locklint"):
        import importlib

        return importlib.import_module(f".{name}", __name__)
    if name == "InvariantError":
        from .check import InvariantError

        return InvariantError
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
