"""Host-side request-lifecycle metrics: counters, gauges, histograms.

Port of ``repro/telemetry/metrics.py`` (pure Python, line for line: the
same snapshot JSON and summary strings for the same observations).
Everything here runs on the host, fed by values the engine already
fetched (dispatch results, host mirrors, the device counter tree) —
recording a metric never adds a device sync.  The registry
snapshots to a stable JSON schema (:data:`METRICS_SCHEMA`) so artifacts
from different commits diff cleanly, and summarizes to the p50/p95/p99
lines the serve CLI prints.

Histograms use **fixed log-spaced buckets**: ``n_buckets`` edges spanning
``[lo, hi)`` at a constant ratio, plus an underflow and an overflow
bucket, so two runs of the same histogram are bucket-compatible by
construction.  Exact observations are retained as well (one float per
``observe``; request-scale cardinality), so the exported percentiles are
exact nearest-rank values, not bucket interpolations — the buckets exist
for cross-run diffing and trace counter tracks.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field

METRICS_SCHEMA = "repro.telemetry.metrics/v1"


@dataclass
class Counter:
    """Monotonic count of events."""
    name: str
    value: int = 0

    def inc(self, n: int = 1) -> None:
        self.value += int(n)


@dataclass
class Gauge:
    """Last-written value (None until first set)."""
    name: str
    value: float | None = None

    def set(self, v: float) -> None:
        self.value = float(v)


def log_bucket_edges(lo: float, hi: float, n_buckets: int) -> list[float]:
    """``n_buckets + 1`` log-spaced edges: ``edges[i] = lo * (hi/lo)^(i/n)``
    — ``edges[0] == lo``, ``edges[n] == hi`` (up to float rounding, pinned
    exactly at both ends)."""
    if not (0 < lo < hi):
        raise ValueError(f"need 0 < lo < hi, got lo={lo}, hi={hi}")
    if n_buckets < 1:
        raise ValueError(f"n_buckets must be >= 1, got {n_buckets}")
    ratio = hi / lo
    edges = [lo * ratio ** (i / n_buckets) for i in range(n_buckets + 1)]
    edges[0], edges[-1] = lo, hi
    return edges


@dataclass
class Histogram:
    """Log-bucketed histogram with exact retained observations.

    ``bucket_counts`` has ``n_buckets + 2`` entries: ``[underflow (< lo),
    bucket 0 .. n-1, overflow (>= hi)]``.
    """
    name: str
    lo: float = 1e-4
    hi: float = 1e3
    n_buckets: int = 32
    unit: str = ""
    edges: list[float] = field(init=False)
    bucket_counts: list[int] = field(init=False)
    _samples: list[float] = field(init=False, default_factory=list)

    def __post_init__(self):
        self.edges = log_bucket_edges(self.lo, self.hi, self.n_buckets)
        self.bucket_counts = [0] * (self.n_buckets + 2)

    def observe(self, v: float) -> None:
        v = float(v)
        self._samples.append(v)
        if v < self.lo:
            self.bucket_counts[0] += 1
        elif v >= self.hi:
            self.bucket_counts[-1] += 1
        else:
            # constant-ratio buckets: the index is a single log
            i = int(math.log(v / self.lo)
                    / math.log(self.hi / self.lo) * self.n_buckets)
            i = min(max(i, 0), self.n_buckets - 1)
            # float rounding at an edge can land one bucket off; nudge
            if v < self.edges[i]:
                i -= 1
            elif v >= self.edges[i + 1]:
                i += 1
            self.bucket_counts[1 + i] += 1

    @property
    def count(self) -> int:
        return len(self._samples)

    def percentile(self, q: float) -> float | None:
        """Exact nearest-rank percentile (``q`` in (0, 100]); None when
        empty."""
        if not self._samples:
            return None
        s = sorted(self._samples)
        rank = max(1, math.ceil(q / 100.0 * len(s)))
        return s[rank - 1]

    def to_dict(self) -> dict:
        out = {
            "unit": self.unit,
            "edges": self.edges,
            "counts": list(self.bucket_counts),
            "count": self.count,
        }
        if self._samples:
            out.update(
                sum=float(sum(self._samples)),
                min=float(min(self._samples)),
                max=float(max(self._samples)),
                p50=self.percentile(50),
                p95=self.percentile(95),
                p99=self.percentile(99),
            )
        return out


class MetricsRegistry:
    """Get-or-create registry of named metrics with a stable snapshot.

    One registry typically lives across a CLI run or a benchmark; the
    engine records into it when passed as ``Engine(..., metrics=reg)``.
    """

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        return self._counters.setdefault(name, Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self._gauges.setdefault(name, Gauge(name))

    def histogram(self, name: str, *, lo: float = 1e-4, hi: float = 1e3,
                  n_buckets: int = 32, unit: str = "") -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = Histogram(name, lo=lo, hi=hi, n_buckets=n_buckets,
                          unit=unit)
            self._histograms[name] = h
        return h

    def snapshot(self) -> dict:
        """Stable-schema dict (sorted keys, plain JSON types) — the single
        source of truth the serve CLI summary and BENCH artifacts embed."""
        return {
            "schema": METRICS_SCHEMA,
            "counters": {k: c.value
                         for k, c in sorted(self._counters.items())},
            "gauges": {k: g.value
                       for k, g in sorted(self._gauges.items())},
            "histograms": {k: h.to_dict()
                           for k, h in sorted(self._histograms.items())},
        }

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True)
            f.write("\n")

    def summary(self) -> str:
        """Human-readable p50/p95/p99 lines for the serve CLI."""
        lines = []
        for name, h in sorted(self._histograms.items()):
            if not h.count:
                continue
            unit = f" {h.unit}" if h.unit else ""
            lines.append(
                f"  {name}: p50={h.percentile(50):.4g} "
                f"p95={h.percentile(95):.4g} "
                f"p99={h.percentile(99):.4g}{unit} (n={h.count})")
        for name, g in sorted(self._gauges.items()):
            val = "n/a" if g.value is None else f"{g.value:.4g}"
            lines.append(f"  {name}: {val}")
        for name, c in sorted(self._counters.items()):
            lines.append(f"  {name}: {c.value}")
        return "\n".join(lines)
