"""Rolling-window SLO tracking over registry histograms (a copy of the JAX
package's ``obs/slo.py``).

The registry's histograms are *cumulative* — perfect for a benchmark window,
useless for "are we breaching **right now**". The tracker turns a cumulative
histogram (normally ``gateway.request_ms``) into a sliding window by diffing
bucket counts against a baseline on every ``tick()`` and keeping the deltas
in a time-stamped deque; the window view is the :meth:`Histogram.merge` of
the surviving deltas, so the windowed p99 has full bucket fidelity, not an
average-of-percentiles.

Burn-rate semantics (the SRE error-budget formulation): the target is
"p99 <= ``p99_ms``", i.e. at most ``budget`` (default 1%) of requests may
exceed the threshold. ``burn = violation_rate / budget`` — burn 1.0 spends
the budget exactly as fast as it accrues; the tracker reports

    ok      burn < warn_burn   (default 1.0)
    warn    warn_burn <= burn < breach_burn (default 2.0)
    breach  burn >= breach_burn

computed over the last ``window_s`` seconds only, so a breach *recovers* on
its own once the slow requests age out of the window. An empty window is
``ok`` (no traffic is not an outage).

The tracker never mutates the histogram it watches and rebaselines itself on
``MetricsRegistry.reset()`` (benchmark lap boundaries) — a reset shrinks the
cumulative counts, and a naive diff would otherwise go negative.
"""
from __future__ import annotations

import bisect
import collections

from repro_torch.obs.clock import now as _now
from repro_torch.obs.metrics import Histogram, MetricsRegistry

__all__ = ["SLOTracker", "parse_slo_spec"]

# --slo flag grammar: comma-separated k=v; p99_ms is the only required key
_SPEC_KEYS = ("p99_ms", "window_s", "budget", "warn_burn", "breach_burn")


def parse_slo_spec(text: str) -> dict:
    """Parse ``"p99_ms=250"`` / ``"p99_ms=250,window_s=10,budget=0.05"``
    into SLOTracker kwargs. Raises ValueError on unknown keys or a missing
    p99_ms — a misspelled SLO must fail at launch, not silently monitor
    nothing."""
    out = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        key, sep, val = part.partition("=")
        key = key.strip()
        if not sep or key not in _SPEC_KEYS:
            raise ValueError(
                f"bad --slo entry {part!r} (known keys: {', '.join(_SPEC_KEYS)})"
            )
        out[key] = float(val)
    if "p99_ms" not in out:
        raise ValueError("--slo needs p99_ms=<threshold>")
    return out


class SLOTracker:
    """Windowed p99 + error-budget burn state over one registry histogram.

    ``tick()`` is cheap (one locked histogram read, one deque append when
    there is new traffic) and is called opportunistically from the serving
    path (once per delivered wave) and from every stats/metrics read, so the
    reported state is current whenever anyone looks.
    """

    def __init__(
        self,
        metrics: MetricsRegistry,
        *,
        p99_ms: float,
        hist: str = "gateway.request_ms",
        window_s: float = 30.0,
        budget: float = 0.01,
        warn_burn: float = 1.0,
        breach_burn: float = 2.0,
        clock=_now,
    ):
        assert p99_ms > 0 and window_s > 0 and 0 < budget <= 1
        assert warn_burn <= breach_burn
        self.p99_ms = float(p99_ms)
        self.window_s = float(window_s)
        self.budget = float(budget)
        self.warn_burn = float(warn_burn)
        self.breach_burn = float(breach_burn)
        self._clock = clock
        self._hist = metrics.histogram(hist)
        self._baseline = self._hist.state()
        # (t, delta-Histogram) newest-last; merged on demand for the window
        self._window: collections.deque = collections.deque()
        self._total_seen = 0
        # a registry reset() shrinks the cumulative counts mid-flight; the
        # hook rebaselines so the first post-reset tick doesn't diff against
        # a pre-reset world (the negative-delta check below is the backstop
        # for resets that bypass the registry)
        metrics.on_reset(self.rebaseline)

    def rebaseline(self) -> None:
        """Forget everything: fresh baseline, empty window."""
        self._baseline = self._hist.state()
        self._window.clear()

    def tick(self, t: float | None = None) -> None:
        """Fold new samples (since the last tick) into the window and evict
        entries older than ``window_s``. Callable from any thread."""
        t = self._clock() if t is None else t
        counts, count, total, vmin, vmax = self._hist.state()
        b_counts, b_count, b_total, _, _ = self._baseline
        if count < b_count or any(c < b for c, b in zip(counts, b_counts)):
            # the histogram went backwards: reset outside the hook path
            self._baseline = (counts, count, total, vmin, vmax)
            self._window.clear()
            return
        if count > b_count:
            delta = Histogram(self._hist.name, None, self._hist.bounds)
            delta.counts = [c - b for c, b in zip(counts, b_counts)]
            delta.count = count - b_count
            delta.total = total - b_total
            # extrema of the delta are unknowable from cumulative state;
            # bucket edges stand in (percentiles stay bucket-accurate)
            delta._derive_extrema()
            self._window.append((t, delta))
            self._total_seen += delta.count
            self._baseline = (counts, count, total, vmin, vmax)
        horizon = t - self.window_s
        while self._window and self._window[0][0] < horizon:
            self._window.popleft()

    # ----------------------------------------------------------------- state
    def _merged(self) -> Histogram:
        h = Histogram(self._hist.name, None, self._hist.bounds)
        for _, delta in self._window:
            h.merge(delta)
        return h

    def _violations(self, h: Histogram) -> float:
        """Estimated number of window samples above ``p99_ms`` (fractional:
        linear interpolation inside the straddling bucket)."""
        if not h.count:
            return 0.0
        i = bisect.bisect_left(h.bounds, self.p99_ms)
        above = float(sum(h.counts[i + 1:])) if i < len(h.counts) else 0.0
        if i < len(h.counts) and h.counts[i]:
            lo = h.bounds[i - 1] if i > 0 else 0.0
            hi = h.bounds[i] if i < len(h.bounds) else (h.vmax or self.p99_ms)
            frac_above = (hi - self.p99_ms) / (hi - lo) if hi > lo else 0.0
            above += h.counts[i] * min(max(frac_above, 0.0), 1.0)
        return above

    def report(self, t: float | None = None) -> dict:
        """Current window state (ticks first, so it is never stale)."""
        self.tick(t)
        h = self._merged()
        violation_rate = self._violations(h) / h.count if h.count else 0.0
        burn = violation_rate / self.budget
        if not h.count or burn < self.warn_burn:
            state = "ok"
        elif burn < self.breach_burn:
            state = "warn"
        else:
            state = "breach"
        return {
            "target_p99_ms": self.p99_ms,
            "window_s": self.window_s,
            "budget": self.budget,
            "state": state,
            "burn": round(burn, 4),
            "violation_rate": round(violation_rate, 6),
            "window_count": h.count,
            "window_p99_ms": round(h.percentile(99), 3),
            "window_p50_ms": round(h.percentile(50), 3),
            "samples_total": self._total_seen,
        }

    @property
    def state(self) -> str:
        return self.report()["state"]
