"""Deterministic fault injection for chaos-testing the overlay runtime.

The paper's runtime assembles accelerators from *downloaded* bitstreams,
which makes downloads, fabric members, and on-disk artifacts first-class
failure points.  This module provides a seeded :class:`FaultPlan` that the
overlay, fleet, scheduler, and store consult at well-defined choke points
("channels").  Decisions are pure functions of ``(seed, channel, key, n)``
where ``n`` is a per-(channel, key) event counter — no wall-clock reads and
no stateful RNG stream — so the *same* plan seed replays the *same* fault
sequence on every run regardless of thread interleaving.

Channels:
  ``download``      — bitstream compile/download raises :class:`FaultError`
  ``slow_download`` — bitstream compile sleeps ``slow_seconds`` first
  ``dispatch``      — a resident dispatch raises :class:`FaultError`
  ``resident_loss`` — the resident silently vanishes before dispatch
  ``store_read``    — store payload bytes are flipped before validation
  ``store_write``   — store blob is garbled before landing on disk

Member death is threshold-based rather than probabilistic: ``member_deaths``
maps member index -> fleet dispatch count after which the member dies, so a
4-member soak kills the same member at the same point every run.

A copy of ``repro/core/faults.py`` (the port imports nothing of ``repro``):
the same hash of the same string decides, so a plan fires exactly what the
reference's plan fires on the same key sequences.  The bitstream store
reads the ``store_*`` channels and the fleet reads ``member_deaths``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from typing import Iterable

__all__ = ["FaultError", "FaultEvent", "FaultPlan"]

_CHANNELS = ("download", "slow_download", "dispatch", "resident_loss",
             "store_read", "store_write")


class FaultError(RuntimeError):
    """An injected (synthetic) failure.

    Raised by fault choke points when the plan fires.  Handlers treat it
    like any other runtime failure — it must never escape to callers of
    the public overlay API; it degrades to residue/retry instead.
    """


@dataclasses.dataclass(frozen=True, order=True)
class FaultEvent:
    """One fired fault: channel, the key it hit, and its event ordinal."""

    channel: str
    key: str
    n: int


class FaultPlan:
    """Seeded, replayable fault schedule.

    Each ``fires(channel, key)`` call increments the per-(channel, key)
    event counter ``n`` and derives the decision from a blake2b hash of
    ``"{seed}|{channel}|{key}|{n}"`` mapped to [0, 1) and compared against
    the channel's rate.  Because the decision depends only on how many
    times *that* key hit *that* channel — not on global ordering — two runs
    with identical per-key event sequences fire identical faults even when
    threads interleave differently.

    ``events()`` returns the fired-fault ledger as a canonically sorted
    tuple (append order varies across threads; the *set* does not).
    """

    def __init__(self, seed: int = 0, *,
                 download_failure_rate: float = 0.0,
                 slow_download_rate: float = 0.0,
                 slow_seconds: float = 0.0,
                 dispatch_failure_rate: float = 0.0,
                 resident_loss_rate: float = 0.0,
                 store_read_corrupt_rate: float = 0.0,
                 store_write_corrupt_rate: float = 0.0,
                 member_deaths: dict[int, int] | None = None) -> None:
        self.seed = int(seed)
        self.rates = {
            "download": float(download_failure_rate),
            "slow_download": float(slow_download_rate),
            "dispatch": float(dispatch_failure_rate),
            "resident_loss": float(resident_loss_rate),
            "store_read": float(store_read_corrupt_rate),
            "store_write": float(store_write_corrupt_rate),
        }
        for ch, rate in self.rates.items():
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"rate for {ch!r} must be in [0, 1]: {rate}")
        self.slow_seconds = float(slow_seconds)
        self.member_deaths = dict(member_deaths or {})
        self._lock = threading.Lock()
        self._counts: dict[tuple[str, str], int] = {}
        self._events: list[FaultEvent] = []
        self._killed: set[int] = set()

    # -- decision machinery ------------------------------------------------

    def _roll(self, channel: str, key: str, n: int) -> float:
        h = hashlib.blake2b(f"{self.seed}|{channel}|{key}|{n}".encode(),
                            digest_size=8).digest()
        return int.from_bytes(h, "big") / 2.0 ** 64

    def fires(self, channel: str, key: str) -> bool:
        """Tick the (channel, key) counter; True when this event faults."""
        if channel not in _CHANNELS:
            raise ValueError(f"unknown fault channel {channel!r}")
        rate = self.rates[channel]
        with self._lock:
            n = self._counts.get((channel, key), 0) + 1
            self._counts[(channel, key)] = n
            if rate <= 0.0 or self._roll(channel, key, n) >= rate:
                return False
            self._events.append(FaultEvent(channel, key, n))
            return True

    def members_to_kill(self, dispatch_count: int) -> list[int]:
        """Member indices whose death threshold has passed, once each."""
        with self._lock:
            due = [idx for idx, after in sorted(self.member_deaths.items())
                   if dispatch_count >= after and idx not in self._killed]
            self._killed.update(due)
            return due

    # -- introspection -----------------------------------------------------

    def events(self) -> tuple[FaultEvent, ...]:
        """Fired faults, canonically sorted (thread-order independent)."""
        with self._lock:
            return tuple(sorted(self._events))

    def event_counts(self) -> dict[str, int]:
        """Fired faults per channel."""
        with self._lock:
            counts: dict[str, int] = {}
            for ev in self._events:
                counts[ev.channel] = counts.get(ev.channel, 0) + 1
            return counts

    def describe(self) -> dict:
        with self._lock:
            return {
                "seed": self.seed,
                "rates": {ch: r for ch, r in self.rates.items() if r > 0.0},
                "member_deaths": dict(self.member_deaths),
                "fired": len(self._events),
                "killed": sorted(self._killed),
            }

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        active = ", ".join(f"{ch}={r}" for ch, r in self.rates.items() if r)
        return f"FaultPlan(seed={self.seed}, {active or 'inert'})"


def replay_identical(a: Iterable[FaultEvent], b: Iterable[FaultEvent]) -> bool:
    """True when two fault ledgers describe the same fault sequence."""
    return tuple(sorted(a)) == tuple(sorted(b))
