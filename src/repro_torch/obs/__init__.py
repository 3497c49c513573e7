"""Observability for the port's serving stack (copies of the JAX package's
``obs/clock.py``, ``obs/metrics.py``, ``obs/trace.py``, ``obs/export.py``
and ``obs/slo.py``, a port of ``obs/devmem.py``, plus ``Obs``).

One ``Obs`` bundle travels down the stack (gateway → sessions → engine →
cache → encoders): it owns the
shared :class:`MetricsRegistry` (atomic snapshot, one ``reset()`` for every
tier) and the span recorder — :data:`NULL_RECORDER` (falsy; tracing
disabled, zero hot-path cost) unless tracing was requested. Components that
are constructed standalone default to their own private ``Obs`` so the
instrumentation never needs a None check.
"""
from __future__ import annotations

import sys

from repro_torch.obs.clock import now, since
from repro_torch.obs.export import (
    TraceCheck,
    spans_to_chrome,
    spans_to_jsonl,
    trace_meta,
    validate_trace_jsonl,
    write_trace,
)
from repro_torch.obs.metrics import (
    DEFAULT_MS_BUCKETS,
    DEFAULT_SIZE_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.slo import SLOTracker, parse_slo_spec
from repro_torch.obs.trace import (
    LOOP_STAGES,
    NULL_RECORDER,
    STAGES,
    STEP_STAGES,
    TRAIN_STAGES,
    NullRecorder,
    Span,
    TraceRecorder,
    new_request_id,
)
from repro_torch.obs import devmem, steptrace

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
    "TRAIN_STAGES",
    "LOOP_STAGES",
    "STEP_STAGES",
    "devmem",
    "steptrace",
    "new_request_id",
    "spans_to_jsonl",
    "spans_to_chrome",
    "write_trace",
    "validate_trace_jsonl",
    "trace_meta",
    "TraceCheck",
    "SLOTracker",
    "parse_slo_spec",
    "export_trace",
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


def export_trace(recorder, path: str, knobs: dict) -> TraceCheck:
    """The ``--trace-out`` tail of every CLI: drain ``recorder`` into
    ``path`` (JSONL) and its ``.chrome.json`` sibling with the export header
    (drop accounting + the ``knobs`` that produced the trace), validate the
    JSONL back, print where it went, and warn when the ring overflowed."""
    spans = recorder.drain()
    jsonl_path, chrome_path = write_trace(path, spans, meta=trace_meta(recorder, knobs=knobs))
    with open(jsonl_path) as f:
        n = validate_trace_jsonl(f.read())
    print(f"trace: {n} spans -> {jsonl_path} + {chrome_path}")
    if n.dropped:
        print(f"WARNING: span ring overflowed — {n.dropped} spans LOST (capacity {recorder.capacity}); "
              f"raise --trace-capacity before trusting the trace", file=sys.stderr)
    return n
