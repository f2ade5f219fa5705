"""Latency/throughput accounting for the serve runtime.

The engine records one end-to-end latency and one time-to-first-token per
request; the queue keeps an EWMA of batch-step service time that drives
its SLO-budget load shedding. All summaries report milliseconds — the
unit the paper's sub-second-duty argument is made in.
"""
from __future__ import annotations

import bisect
from typing import Dict, Optional

from ..analysis.runtime import make_lock

__all__ = ["LatencyStats", "EWMA"]


class LatencyStats:
    """Thread-safe latency reservoir with percentile queries.

    Bounded: past ``maxlen`` samples the oldest half is dropped, so a
    long-lived engine never grows without bound while percentiles stay
    dominated by recent traffic.

    Percentile queries are O(1): an ordered view is maintained
    incrementally on ``record`` (``bisect.insort``) instead of re-sorting
    the full reservoir per call. A mesh router polls every replica's stats
    on each scheduling tick, so ``summary()``/``percentile()`` must stay
    cheap no matter how full the reservoir is (the old per-call sort was
    O(n log n) over up to 100k samples — per tick, per replica).
    """

    def __init__(self, maxlen: int = 100_000):
        self._lock = make_lock("LatencyStats")
        self._samples: list[float] = []    # arrival order (drives eviction)
        self._ordered: list[float] = []    # same samples, kept sorted
        self._sum = 0.0                    # running sum of the reservoir
        self._maxlen = maxlen
        self._count = 0

    def record(self, seconds: float) -> None:
        s = float(seconds)
        with self._lock:
            self._count += 1
            self._samples.append(s)
            bisect.insort(self._ordered, s)
            self._sum += s
            if len(self._samples) > self._maxlen:
                dropped = self._samples[:self._maxlen // 2]
                del self._samples[:self._maxlen // 2]
                self._sum -= sum(dropped)
                # one O(n log n) rebuild per maxlen/2 records, amortized
                # O(log n) per record — never on the query path
                self._ordered = sorted(self._samples)

    @staticmethod
    def _rank(ordered: list, p: float) -> float:
        # nearest-rank on a pre-sorted sample list
        rank = min(len(ordered) - 1,
                   max(0, int(round(p / 100.0 * (len(ordered) - 1)))))
        return ordered[rank]

    def percentile(self, p: float) -> float:
        """The ``p``-th percentile in seconds (nearest-rank); 0.0 when no
        samples were recorded yet."""
        with self._lock:
            if not self._ordered:
                return 0.0
            return self._rank(self._ordered, p)

    def summary(self) -> Dict[str, float]:
        with self._lock:
            if not self._ordered:
                return {"count": self._count, "p50_ms": 0.0, "p95_ms": 0.0,
                        "p99_ms": 0.0, "mean_ms": 0.0, "max_ms": 0.0}
            ordered = self._ordered
            return {
                "count": self._count,
                "p50_ms": self._rank(ordered, 50) * 1e3,
                "p95_ms": self._rank(ordered, 95) * 1e3,
                "p99_ms": self._rank(ordered, 99) * 1e3,
                "mean_ms": self._sum / len(ordered) * 1e3,
                "max_ms": ordered[-1] * 1e3,
            }


class EWMA:
    """Exponentially weighted moving average (service-time estimator)."""

    def __init__(self, alpha: float = 0.2):
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        self.alpha = alpha
        self._value: Optional[float] = None
        self._lock = make_lock("EWMA")

    def update(self, x: float) -> float:
        with self._lock:
            if self._value is None:
                self._value = float(x)
            else:
                self._value += self.alpha * (float(x) - self._value)
            return self._value

    @property
    def value(self) -> Optional[float]:
        return self._value
