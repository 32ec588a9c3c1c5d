"""Cheap fixed-bucket histograms for dispatch/serving observability.

The overlay records into these on its dispatch fast path, so the design
constraint is cost, not fidelity: :meth:`Histogram.record` is one integer
``bit_length`` plus two list/scalar updates — no locks (single increments
are atomic enough under the GIL for an *estimate*; these feed placement
scores and SLO admission, not billing), no allocation, no time syscalls of
its own.  Buckets are powers of two, so 32 buckets cover ~9 decades (values
are typically microseconds or hop counts).

A copy of ``repro/serving/metrics.py`` (the port imports nothing of
``repro``).  It is dependency-free: ``repro_torch.core.overlay`` and
``repro_torch.core.fabric`` import it without pulling in the serving
engine.
"""

from __future__ import annotations

__all__ = ["Histogram", "merge_counts"]

_N_BUCKETS = 32


def merge_counts(*ledgers: "dict | None") -> dict:
    """Merge counter ledgers (e.g. ``Overlay.failure_ledger()`` outputs
    from several members or runs): numeric values sum, list values union
    (deduplicated, sorted), nested dicts merge recursively, ``None``
    ledgers are skipped.  Mismatched value types take the later ledger's
    value — ledger data is observability, not billing."""
    out: dict = {}
    for ledger in ledgers:
        if not ledger:
            continue
        for key, value in ledger.items():
            have = out.get(key)
            if isinstance(value, bool) or isinstance(have, bool):
                out[key] = value
            elif isinstance(have, (int, float)) and \
                    isinstance(value, (int, float)):
                out[key] = have + value
            elif isinstance(have, list) and isinstance(value, list):
                out[key] = sorted(set(have) | set(value))
            elif isinstance(have, dict) and isinstance(value, dict):
                out[key] = merge_counts(have, value)
            elif isinstance(value, list):
                out[key] = sorted(set(value))
            else:
                out[key] = value
    return out


class Histogram:
    """Power-of-two-bucket histogram: bucket ``i`` counts values ``v`` with
    ``int(v).bit_length() == i`` (i.e. roughly ``2**(i-1) <= v < 2**i``;
    ``v < 1`` lands in bucket 0).  O(1) record, O(buckets) percentile."""

    __slots__ = ("counts", "count", "total", "max")

    def __init__(self) -> None:
        self.counts = [0] * _N_BUCKETS
        self.count = 0
        self.total = 0.0
        self.max = 0.0

    def record(self, value: float) -> None:
        """Add one observation.  Negative values clamp to 0."""
        if value < 0.0:
            value = 0.0
        b = int(value).bit_length()
        if b >= _N_BUCKETS:
            b = _N_BUCKETS - 1
        self.counts[b] += 1
        self.count += 1
        self.total += value
        if value > self.max:
            self.max = value

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Upper bucket bound of the q-quantile (q in [0, 1]); 0.0 when
        empty.  Clamped to the true observed max, so a histogram fed one
        value reports that value (not its bucket's power-of-two edge)."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        cum = 0
        for b, c in enumerate(self.counts):
            cum += c
            if cum >= rank and c:
                return min(float(1 << b) if b else 1.0, self.max)
        return self.max

    def summary(self) -> dict:
        """JSON-serializable digest (``describe()`` embeds this)."""
        return {
            "count": self.count,
            "mean": round(self.mean(), 3),
            "p50": round(self.percentile(0.50), 3),
            "p99": round(self.percentile(0.99), 3),
            "max": round(self.max, 3),
        }

    def state(self) -> dict:
        """Full JSON-serializable state — lossless, unlike :meth:`summary`.

        Used by the bitstream store's measurement ledger so a warm boot can
        re-seed dispatch-latency histograms instead of starting blind."""
        return {
            "counts": list(self.counts),
            "count": self.count,
            "total": self.total,
            "max": self.max,
        }

    @classmethod
    def from_state(cls, state: dict) -> "Histogram":
        """Rebuild from :meth:`state` output; malformed state (wrong types,
        wrong bucket count) yields an empty histogram rather than raising —
        ledger data comes off disk and must never break a boot."""
        h = cls()
        try:
            counts = [int(c) for c in state["counts"]]
            count = int(state["count"])
            total = float(state["total"])
            mx = float(state["max"])
        except (KeyError, TypeError, ValueError):
            return h
        if len(counts) != _N_BUCKETS or count < 0 or any(c < 0 for c in counts):
            return h
        h.counts = counts
        h.count = count
        h.total = total
        h.max = mx
        return h

    def merge(self, other: "Histogram") -> None:
        """Fold another histogram's observations into this one."""
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.total += other.total
        if other.max > self.max:
            self.max = other.max

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        s = self.summary()
        return (f"Histogram(count={s['count']}, p50={s['p50']}, "
                f"p99={s['p99']}, max={s['max']})")
