"""Mergeable serving metrics: counters, gauges, streaming histograms.

Metrics are *always on* — like :class:`~repro.serve.executor.ExecutorStats`
they are a handful of host-side integer/float updates per event, far
below measurement noise next to a device step — so latency SLOs don't
require re-running with a flag.  What ``REPRO_TRACE`` gates is the
per-event *trace*, not these aggregates.

Histograms use **fixed log-spaced buckets** (quarter-decade edges from
1 µs to 1000 s by default).  Fixed edges make merge a bucket-wise
integer addition — associative, commutative, and count-conserving — so
per-replica registries fold across replicas and across replica
*incarnations* (resurrection carries the dead incarnation's registry
into the fresh executor) exactly like ``Ledger.__add__``.  Percentiles
are estimated from bucket edges, so a merged histogram reports the same
quantiles regardless of merge order.
"""

from __future__ import annotations

from bisect import bisect_left
from typing import Dict, Iterable, Optional, Sequence, Tuple

#: quarter-decade log-spaced edges, 1e-6 .. 1e3 seconds.  Generated from
#: integer exponents so every process computes bit-identical floats.
DEFAULT_BOUNDS: Tuple[float, ...] = tuple(
    10.0 ** (e / 4.0) for e in range(-24, 13))

#: edges suited to small non-negative integers (queue depth, pages,
#: retries): 1, 2, 4, ... 65536 — log-spaced base 2
COUNT_BOUNDS: Tuple[float, ...] = tuple(float(2 ** e) for e in range(0, 17))


class Counter:
    """A monotone counter.  Merge = addition."""

    __slots__ = ("value",)

    def __init__(self, value: float = 0):
        self.value = value

    def inc(self, n: float = 1) -> None:
        self.value += n

    def merge(self, other: "Counter") -> None:
        self.value += other.value

    def snapshot(self) -> float:
        return self.value


class Gauge:
    """A last-value gauge that also tracks its high-water mark.

    Merge sums both — for the gauges this registry carries (queue depth,
    outstanding tokens, free pages) the cluster-wide reading *is* the
    sum over replicas, and peak-of-sums is approximated by sum-of-peaks
    (an upper bound, noted in the snapshot key name).
    """

    __slots__ = ("value", "peak")

    def __init__(self):
        self.value = 0.0
        self.peak = 0.0

    def set(self, v: float) -> None:
        self.value = v
        if v > self.peak:
            self.peak = v

    def merge(self, other: "Gauge") -> None:
        self.value += other.value
        self.peak += other.peak

    def snapshot(self) -> Dict[str, float]:
        return {"value": self.value, "peak": self.peak}


class Histogram:
    """Streaming histogram over fixed log-spaced bucket edges.

    ``bounds`` are upper-inclusive edges; one overflow bucket catches
    everything above the last edge.  ``count``/``total`` are exact;
    quantiles are bucket-edge estimates.  Two histograms merge iff their
    edges are identical — bucket-wise addition, so merge is associative
    and conserves counts exactly (the property the replica-incarnation
    tests pin).
    """

    __slots__ = ("bounds", "counts", "count", "total", "vmin", "vmax")

    def __init__(self, bounds: Sequence[float] = DEFAULT_BOUNDS):
        self.bounds = tuple(bounds)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError("histogram bounds must be strictly increasing")
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")

    def record(self, v: float) -> None:
        self.counts[bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def merge(self, other: "Histogram") -> None:
        if self.bounds != other.bounds:
            raise ValueError("cannot merge histograms with different bounds")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)

    def percentile(self, q: float) -> float:
        """Bucket-edge estimate of the ``q``-quantile (0 < q <= 1).

        Returns the upper edge of the bucket holding the q-th sample,
        clamped to the observed [min, max] so estimates never leave the
        data's range.  Deterministic given the bucket counts, hence
        stable under any merge order.
        """
        if self.count == 0:
            return 0.0
        rank = max(1, int(q * self.count + 0.999999))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                edge = (self.bounds[i] if i < len(self.bounds)
                        else self.vmax)
                return min(max(edge, self.vmin), self.vmax)
        return self.vmax

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def snapshot(self) -> Dict[str, object]:
        buckets = {f"{self.bounds[i]:.6g}": c
                   for i, c in enumerate(self.counts[:-1]) if c}
        if self.counts[-1]:
            buckets["+Inf"] = self.counts[-1]
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.vmin if self.count else 0.0,
            "max": self.vmax if self.count else 0.0,
            "mean": self.mean,
            "p50": self.percentile(0.50),
            "p90": self.percentile(0.90),
            "p99": self.percentile(0.99),
            "buckets": buckets,
        }


class MetricsRegistry:
    """Get-or-create registry of named metrics, mergeable like Ledger.

    One registry per executor; the cluster folds replica registries with
    ``sum(..., MetricsRegistry())``.  Name collisions across kinds are
    an error — a name is one metric everywhere.
    """

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, kind, factory):
        m = self._metrics.get(name)
        if m is None:
            m = factory()
            self._metrics[name] = m
        elif not isinstance(m, kind):
            raise TypeError(
                f"metric {name!r} is {type(m).__name__}, not {kind.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge, Gauge)

    def histogram(self, name: str,
                  bounds: Optional[Sequence[float]] = None) -> Histogram:
        return self._get(name, Histogram,
                         lambda: Histogram(bounds or DEFAULT_BOUNDS))

    def get(self, name: str):
        return self._metrics.get(name)

    def names(self) -> Iterable[str]:
        return sorted(self._metrics)

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        for name, m in other._metrics.items():
            mine = self._metrics.get(name)
            if mine is None:
                # fresh copy so the source registry stays independent
                if isinstance(m, Counter):
                    mine = Counter()
                elif isinstance(m, Gauge):
                    mine = Gauge()
                else:
                    mine = Histogram(m.bounds)
                self._metrics[name] = mine
            mine.merge(m)
        return self

    def __add__(self, other: "MetricsRegistry") -> "MetricsRegistry":
        out = MetricsRegistry()
        out.merge(self)
        out.merge(other)
        return out

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """Plain-dict surface: {"counters": .., "gauges": .., "histograms": ..}."""
        out: Dict[str, Dict[str, object]] = {
            "counters": {}, "gauges": {}, "histograms": {}}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, Counter):
                out["counters"][name] = m.snapshot()
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.snapshot()
            else:
                out["histograms"][name] = m.snapshot()
        return out


def registry_of(obj) -> Optional[MetricsRegistry]:
    """The registry attached to ``obj`` (client, executor, cluster), or
    None — join operators use this to book per-operator metrics against
    any backend that carries one."""
    reg = getattr(obj, "metrics", None)
    return reg if isinstance(reg, MetricsRegistry) else None


__all__ = [
    "COUNT_BOUNDS",
    "Counter",
    "DEFAULT_BOUNDS",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "registry_of",
]
