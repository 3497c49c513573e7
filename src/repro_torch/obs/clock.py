"""One monotonic clock for every serving tier.

Every timestamp that ends up in a span, a latency histogram, or a wall-time
sum must come from the SAME monotonic clock, or cross-tier arithmetic
(gateway wait minus engine render, span trees stitched across threads) mixes
epochs and produces negative stage times. ``now()`` is the canonical clock:
``time.perf_counter`` — monotonic, process-wide, highest available
resolution. Tiers import *this name* instead of calling ``time`` directly so
the choice is made exactly once.

``perf_counter``'s epoch is arbitrary (process start-ish). Exporters that
need wall-clock alignment subtract a reference taken at trace start; nothing
in the serving stack ever compares these timestamps across processes.
"""
from __future__ import annotations

import time

# the canonical monotonic clock: seconds, float, arbitrary epoch
now = time.perf_counter


def since(t0: float) -> float:
    """Seconds elapsed since ``t0`` (a ``now()`` reading)."""
    return now() - t0
