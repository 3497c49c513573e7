"""Typed metrics registry: counters, gauges, fixed-bucket histograms.

One registry serves a whole serving stack (engine + cache + sessions +
gateway + encoders): every tier registers its metrics under a dotted name
(``server.completed``, ``gateway.frames_sent``, ``cache.hits``) and the
registry provides the two operations the loose per-tier counters never had:

``snapshot()``
    An **atomic** point-in-time read of every metric. All mutators and the
    snapshot share one registry lock, so a reader on the event-loop thread
    can never observe a torn pair (e.g. ``hits`` incremented but ``misses``
    not yet) while the render-executor thread is mid-update.

``reset()``
    Zero every metric across every tier in one call — the benchmark-window
    contract. Components whose window state lives outside the registry
    (plain lists, first/last timestamps) hook in via ``on_reset`` so one
    reset really clears the whole stack.

Counters accept float increments (wall-time sums are counters too).
Histograms use fixed bucket boundaries, so recording is O(log buckets) with
no per-sample allocation, and p50/p95/p99 are estimated by linear
interpolation inside the bucket — the shape a replay harness or a
cross-run diff can consume without shipping raw sample lists.
"""
from __future__ import annotations

import bisect
import threading

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "DEFAULT_MS_BUCKETS",
    "DEFAULT_SIZE_BUCKETS",
]

# latency-style buckets (milliseconds): ~logarithmic from 50us to 60s
DEFAULT_MS_BUCKETS = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 60000.0,
)

# small-integer buckets (batch sizes, ring occupancy, queue depths)
DEFAULT_SIZE_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 128, 256)


class Counter:
    """Monotonically increasing value (int or float). Registry-locked."""

    __slots__ = ("name", "_lock", "_v")

    def __init__(self, name: str, lock: threading.RLock):
        self.name = name
        self._lock = lock
        self._v = 0

    def inc(self, n=1) -> None:
        with self._lock:
            self._v += n

    add = inc  # timing sums read better as .add(seconds)

    @property
    def value(self):
        return self._v

    def snapshot(self):
        return self._v

    def _reset(self) -> None:  # caller holds the registry lock
        self._v = 0


class Gauge:
    """A value that goes up and down (queue depth, bytes held)."""

    __slots__ = ("name", "_lock", "_v")

    def __init__(self, name: str, lock: threading.RLock):
        self.name = name
        self._lock = lock
        self._v = 0

    def set(self, v) -> None:
        with self._lock:
            self._v = v

    def inc(self, n=1) -> None:
        with self._lock:
            self._v += n

    def dec(self, n=1) -> None:
        with self._lock:
            self._v -= n

    @property
    def value(self):
        return self._v

    def snapshot(self):
        return self._v

    def _reset(self) -> None:
        self._v = 0


class Histogram:
    """Fixed-bucket histogram with exact count/sum/min/max and interpolated
    percentiles. Bucket ``i`` counts samples ``<= bounds[i]``; one overflow
    bucket catches the rest.

    Histograms are *mergeable*: ``merge`` sums two histograms with identical
    bounds without losing percentile fidelity (bucket counts add exactly),
    and ``to_dict``/``from_dict`` round-trip one through JSON — the shape a
    benchmark needs to sum per-lap registry snapshots, and the shape the SLO
    tracker needs to window deltas of a cumulative histogram."""

    __slots__ = ("name", "_lock", "bounds", "counts", "count", "total", "vmin", "vmax")

    def __init__(self, name: str, lock: threading.RLock | None = None,
                 bounds=DEFAULT_MS_BUCKETS):
        assert list(bounds) == sorted(bounds) and len(bounds) >= 1, bounds
        self.name = name
        # standalone use (merge accumulators, windowed deltas) gets a private
        # lock; registry-owned histograms share the registry lock
        self._lock = lock if lock is not None else threading.RLock()
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)  # +1 overflow
        self.count = 0
        self.total = 0.0
        self.vmin = None
        self.vmax = None

    def observe(self, v) -> None:
        v = float(v)
        with self._lock:
            self.counts[bisect.bisect_left(self.bounds, v)] += 1
            self.count += 1
            self.total += v
            self.vmin = v if self.vmin is None else min(self.vmin, v)
            self.vmax = v if self.vmax is None else max(self.vmax, v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Estimated q-th percentile (q in [0, 100]), linear within the
        bucket; exact at the recorded min/max ends. 0 when empty."""
        if not self.count:
            return 0.0
        rank = q / 100.0 * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else min(self.vmin, self.bounds[0])
                hi = self.bounds[i] if i < len(self.bounds) else self.vmax
                lo = max(lo, self.vmin)
                hi = min(hi, self.vmax) if hi is not None else self.vmax
                if hi <= lo:
                    return float(hi)
                frac = (rank - seen) / c
                return float(lo + (hi - lo) * min(max(frac, 0.0), 1.0))
            seen += c
        return float(self.vmax)  # pragma: no cover - arithmetic safety net

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "sum": round(self.total, 6),
            "mean": round(self.mean, 4),
            "min": round(self.vmin, 4) if self.vmin is not None else None,
            "max": round(self.vmax, 4) if self.vmax is not None else None,
            "p50": round(self.percentile(50), 4),
            "p95": round(self.percentile(95), 4),
            "p99": round(self.percentile(99), 4),
            # full serde fields: bounds + dense counts make the snapshot
            # self-describing, so Histogram.from_dict can rebuild (and
            # merge()) a histogram from any registry snapshot or wire copy
            "bounds": list(self.bounds),
            "counts": list(self.counts),
            "buckets": {
                ("le_%g" % b if i < len(self.bounds) else "inf"): c
                for i, (b, c) in enumerate(
                    zip(self.bounds + (float("inf"),), self.counts)
                )
                if c
            },
        }

    to_dict = snapshot

    @classmethod
    def from_dict(cls, d: dict, name: str = "") -> "Histogram":
        """Rebuild a standalone (private-lock) histogram from ``to_dict()`` /
        ``snapshot()`` output. min/max fall back to bucket edges when absent
        (a windowed delta has no exact extrema)."""
        h = cls(name or d.get("name", ""), None, d["bounds"])
        counts = [int(c) for c in d["counts"]]
        if len(counts) != len(h.counts):
            raise ValueError(
                f"counts length {len(counts)} != bounds+1 ({len(h.counts)})"
            )
        h.counts = counts
        h.count = int(d.get("count", sum(counts)))
        h.total = float(d.get("sum", 0.0))
        h.vmin = d.get("min")
        h.vmax = d.get("max")
        h._derive_extrema()
        return h

    def _derive_extrema(self) -> None:
        """Fill missing vmin/vmax from the occupied bucket edges so the
        percentile interpolation stays well-defined."""
        if not self.count:
            return
        occupied = [i for i, c in enumerate(self.counts) if c]
        if self.vmin is None:
            i = occupied[0]
            self.vmin = self.bounds[i - 1] if i > 0 else 0.0
        if self.vmax is None:
            i = occupied[-1]
            self.vmax = self.bounds[min(i, len(self.bounds) - 1)]

    def merge(self, other: "Histogram | dict") -> "Histogram":
        """Fold ``other`` (a Histogram, or a ``to_dict()``/``snapshot()``
        dict) into this histogram in place; returns self. Bucket counts add
        exactly, so percentiles of a merged histogram have the same fidelity
        as if every sample had been observed here — the associativity a
        per-lap benchmark accumulator needs. Bounds must match."""
        if isinstance(other, dict):
            other = Histogram.from_dict(other)
        if tuple(other.bounds) != self.bounds:
            raise ValueError(
                f"cannot merge histograms with different bounds "
                f"({self.name!r} vs {other.name!r})"
            )
        with self._lock:
            for i, c in enumerate(other.counts):
                self.counts[i] += c
            self.count += other.count
            self.total += other.total
            if other.vmin is not None:
                self.vmin = other.vmin if self.vmin is None else min(self.vmin, other.vmin)
            if other.vmax is not None:
                self.vmax = other.vmax if self.vmax is None else max(self.vmax, other.vmax)
        return self

    def state(self) -> tuple:
        """Locked point-in-time read of the mutable fields — the delta
        baseline a windowed consumer (SLO tracker) diffs against."""
        with self._lock:
            return (tuple(self.counts), self.count, self.total, self.vmin, self.vmax)

    def _reset(self) -> None:
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.vmin = self.vmax = None


class MetricsRegistry:
    """Flat namespace of typed metrics with atomic snapshot and one reset.

    ``counter``/``gauge``/``histogram`` are idempotent: asking for an
    existing name returns the existing metric (type-checked), so components
    can re-attach to a shared registry without double-registration errors.
    The lock is reentrant: a reset hook may read metric values."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: dict[str, object] = {}
        self._reset_hooks: list = []

    def _get(self, name: str, cls, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, self._lock, *args)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {type(m).__name__}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, bounds=DEFAULT_MS_BUCKETS) -> Histogram:
        return self._get(name, Histogram, bounds)

    def get(self, name: str):
        return self._metrics.get(name)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    def on_reset(self, hook) -> None:
        """Register ``hook()`` to run inside ``reset()`` — for window state
        that lives outside the registry (plain lists, t_first/t_last)."""
        with self._lock:  # reset() iterates the hooks under this lock
            self._reset_hooks.append(hook)

    def snapshot(self) -> dict:
        """Atomic point-in-time read: {dotted name: value | histogram dict}.
        No mutator can run while the snapshot is being assembled."""
        with self._lock:
            return {name: m.snapshot() for name, m in sorted(self._metrics.items())}

    def reset(self) -> None:
        """Zero every metric in every tier, then run the reset hooks — THE
        benchmark-window boundary (replaces per-tier reset conventions)."""
        with self._lock:
            for m in self._metrics.values():
                m._reset()
            for hook in self._reset_hooks:
                hook()
