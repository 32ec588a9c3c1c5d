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

__all__ = ["Histogram"]

_N_BUCKETS = 32


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

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        s = self.summary()
        return (f"Histogram(count={s['count']}, p50={s['p50']}, "
                f"p99={s['p99']}, max={s['max']})")
