"""Observability for the port's serving stack (copies of the JAX package's
``obs/clock.py``, ``obs/metrics.py`` and ``obs/trace.py``, plus ``Obs``).

One ``Obs`` bundle travels down the stack (engine → cache): it owns the
shared :class:`MetricsRegistry` (atomic snapshot, one ``reset()`` for every
tier) and the span recorder — :data:`NULL_RECORDER` (falsy; tracing
disabled, zero hot-path cost) unless tracing was requested. Components that
are constructed standalone default to their own private ``Obs`` so the
instrumentation never needs a None check.
"""
from __future__ import annotations

from repro_torch.obs.clock import now, since
from repro_torch.obs.metrics import (
    DEFAULT_MS_BUCKETS,
    DEFAULT_SIZE_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.trace import (
    NULL_RECORDER,
    STAGES,
    NullRecorder,
    Span,
    TraceRecorder,
    new_request_id,
)

__all__ = [
    "Obs",
    "now",
    "since",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "DEFAULT_MS_BUCKETS",
    "DEFAULT_SIZE_BUCKETS",
    "TraceRecorder",
    "NullRecorder",
    "NULL_RECORDER",
    "Span",
    "STAGES",
    "new_request_id",
]


class Obs:
    """The observability bundle one serving stack shares.

    ``obs.metrics`` — the registry every tier registers its counters on.
    ``obs.trace`` — a :class:`TraceRecorder` when tracing is on, else the
    falsy :data:`NULL_RECORDER`; hot paths gate on its truthiness.
    """

    __slots__ = ("metrics", "trace")

    def __init__(self, *, trace: bool = False, trace_capacity: int = 65536,
                 metrics: MetricsRegistry | None = None):
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.trace = TraceRecorder(trace_capacity) if trace else NULL_RECORDER

    @property
    def tracing(self) -> bool:
        return bool(self.trace)

    def enable_trace(self, capacity: int = 65536) -> TraceRecorder:
        """Switch tracing on (idempotent); returns the live recorder."""
        if not self.trace:
            self.trace = TraceRecorder(capacity)
        return self.trace

    def disable_trace(self) -> None:
        self.trace = NULL_RECORDER
