"""Trace exporters: JSONL (replay-harness contract) + Chrome trace events
(a copy of the JAX package's ``obs/export.py``: both packages write the
same lines for the same spans).

JSONL — one span per line, the input format for the trace-driven replay
harness (the JAX package's ``obs/replay.py``). The contract, which ``validate_trace_jsonl``
enforces and tests pin:

    {"rid": int >= 0, "span": str, "t0": float, "t1": float >= t0, ...meta}

``rid`` joins a request's spans into one tree; ``span`` is the stage name
(normally from ``trace.STAGES`` — consumers must ignore unknown names);
``t0``/``t1`` are seconds on the shared monotonic clock (``obs.clock.now``),
same epoch across every line of one file. Remaining keys are stage metadata
(batch id/size, cache outcome, encoding, byte counts) and are optional.

An optional FIRST line ``{"trace_meta": {...}}`` carries export metadata:
``dropped`` (spans lost to ring overwrite — a replay fit on a lossy trace is
fit on a lie, so the drop count must travel WITH the data), ``capacity``
(the ring size that caused it), ``recorded``, ``clock`` (the time domain of
``t0``/``t1``), and ``knobs`` (the serving-stack configuration that produced
the trace — the baseline a what-if replay perturbs).

Chrome trace-event JSON — the same spans as complete ("ph": "X") events,
viewable in Perfetto / chrome://tracing. Each stage gets its own lane group,
ordered by pipeline position; spans that overlap in time within one stage
(concurrent requests, or spans recorded from different threads — the render
executor and the event loop write into the same ring) spill into numbered
sub-lanes instead of interleaving into one bar row, so a pipelined wave
reads as parallel bars rather than one garbled lane.
"""
from __future__ import annotations

import json
from typing import Iterable, Sequence

from repro_torch.obs.trace import LOOP_STAGES, STAGES, STEP_STAGES, Span

__all__ = [
    "spans_to_jsonl",
    "spans_to_chrome",
    "write_trace",
    "validate_trace_jsonl",
    "trace_meta",
    "TraceCheck",
    "CLOCK_DOMAIN",
]

_RESERVED = ("rid", "span", "t0", "t1")
META_KEY = "trace_meta"

# the time domain every span's t0/t1 lives in (obs.clock.now = one shared
# monotonic clock per process; cross-process traces must not be merged
# without re-basing, which is why the domain travels in the export header)
CLOCK_DOMAIN = "monotonic"

# lane layout: each stage owns a block of STRIDE tids so overlap sub-lanes
# sort directly under their stage in the Perfetto thread list
LANE_STRIDE = 16


def trace_meta(recorder, knobs: dict | None = None) -> dict:
    """Export metadata for a recorder (``TraceRecorder`` or the null one):
    drop accounting + ring capacity + clock domain, plus the serving-stack
    ``knobs`` that produced the trace when the caller provides them."""
    meta = {
        "recorded": recorder.recorded,
        "dropped": recorder.dropped,
        "capacity": recorder.capacity,
        "clock": CLOCK_DOMAIN,
    }
    if knobs:
        meta["knobs"] = dict(knobs)
    return meta


def spans_to_jsonl(spans: Iterable[Span], meta: dict | None = None) -> str:
    """Render spans as JSONL (one compact object per line, trailing newline;
    empty string for no spans and no meta). ``meta`` becomes a leading
    ``{"trace_meta": {...}}`` line."""
    lines = []
    if meta is not None:
        lines.append(json.dumps({META_KEY: meta}, separators=(",", ":"), default=str))
    for s in spans:
        obj = {"rid": s.rid, "span": s.name, "t0": s.t0, "t1": s.t1}
        for k, v in s.meta.items():
            if k not in _RESERVED:
                obj[k] = v
        lines.append(json.dumps(obj, separators=(",", ":"), default=str))
    return "\n".join(lines) + ("\n" if lines else "")


def spans_to_chrome(spans: Sequence[Span], meta: dict | None = None) -> dict:
    """Render spans as a Chrome trace-event JSON object (Perfetto-viewable).

    One pid; each stage owns a block of lanes (tids) in pipeline order, and
    spans that overlap in time within a stage are assigned to successive
    sub-lanes (greedy interval partitioning), never stacked into one lane —
    spans sharing a rid but recorded from different threads (render executor
    vs event loop) used to interleave into one unreadable bar row.
    Timestamps are microseconds relative to the earliest span so the
    viewport opens on the data instead of hours into an arbitrary epoch.
    ``meta`` (clock domain, drop accounting, knobs) rides in ``otherData``."""
    spans = sorted(spans, key=lambda s: (s.t0, s.seq))
    base = min((s.t0 for s in spans), default=0.0)
    # serving stages first, then training stages: a trace that carries both
    # (insitu run(server=...)) shows training and serving lanes on one clock
    known = STAGES + LOOP_STAGES
    stage_base = {name: (i + 1) * LANE_STRIDE for i, name in enumerate(known)}
    overflow_base = (len(known) + 1) * LANE_STRIDE  # unknown stage names
    # the train step's stages after the overflow block, so that every lane
    # the JAX package lays keeps its tid
    stage_base.update({name: overflow_base + (i + 1) * LANE_STRIDE for i, name in enumerate(STEP_STAGES)})
    # per-stage sub-lane occupancy: lane i is free for a span iff the last
    # span placed there ended at or before this span starts
    lane_busy_until: dict[str, list] = {}
    events = []
    lanes_named: set[int] = set()

    def _name_lane(name: str, tid: int, sub: int) -> None:
        if tid in lanes_named:
            return
        lanes_named.add(tid)
        label = f"{tid // LANE_STRIDE:02d}.{name}" + (f"#{sub}" if sub else "")
        events.append({
            "name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
            "args": {"name": label},
        })

    # always name sub-lane 0 of every known stage, so an empty stage still
    # shows its labelled lane in pipeline order
    for name in STAGES:
        _name_lane(name, stage_base[name], 0)
    for s in spans:
        tbase = stage_base.get(s.name, overflow_base)
        busy = lane_busy_until.setdefault(s.name, [])
        for sub, t_free in enumerate(busy):
            if t_free <= s.t0:
                busy[sub] = max(s.t1, s.t0)
                break
        else:
            sub = len(busy)
            busy.append(max(s.t1, s.t0))
        tid = tbase + sub
        _name_lane(s.name, tid, sub)
        events.append({
            "name": s.name,
            "ph": "X",
            "pid": 1,
            "tid": tid,
            "ts": round((s.t0 - base) * 1e6, 3),
            "dur": round(max(s.t1 - s.t0, 0.0) * 1e6, 3),
            "args": {"rid": s.rid, **s.meta},
        })
    other = {"clock_domain": CLOCK_DOMAIN}
    if meta is not None:
        other.update(meta)
    return {"traceEvents": events, "displayTimeUnit": "ms", "otherData": other}


def write_trace(path: str, spans: Sequence[Span], meta: dict | None = None) -> tuple[str, str]:
    """Write ``path`` (JSONL) and ``path`` with a ``.json`` suffix swapped in
    (Chrome trace events). Returns ``(jsonl_path, chrome_path)``. ``meta``
    (see ``trace_meta``) is embedded in both exports, so drop accounting and
    the producing knob configuration travel with the spans."""
    spans = list(spans)
    jsonl_path = str(path)
    with open(jsonl_path, "w") as f:
        f.write(spans_to_jsonl(spans, meta=meta))
    stem = jsonl_path[: -len(".jsonl")] if jsonl_path.endswith(".jsonl") else jsonl_path
    chrome_path = stem + ".chrome.json"
    with open(chrome_path, "w") as f:
        json.dump(spans_to_chrome(spans, meta=meta), f)
    return jsonl_path, chrome_path


class TraceCheck(int):
    """``validate_trace_jsonl``'s result: the span count (it IS an int, so
    every existing caller keeps working) plus the parsed export metadata —
    ``.meta``, ``.dropped``, ``.capacity`` — so consumers can surface ring
    overflow instead of silently fitting a model to a lossy trace."""

    meta: dict

    def __new__(cls, n: int, meta: dict | None = None):
        self = super().__new__(cls, n)
        self.meta = meta or {}
        return self

    @property
    def dropped(self) -> int:
        return int(self.meta.get("dropped", 0))

    @property
    def capacity(self) -> int | None:
        return self.meta.get("capacity")

    @property
    def knobs(self) -> dict:
        return self.meta.get("knobs") or {}


def validate_trace_jsonl(text: str) -> TraceCheck:
    """Validate JSONL trace text against the schema contract; returns the
    number of span lines (as a :class:`TraceCheck`, an ``int`` carrying the
    export metadata). Raises ``ValueError`` naming the first bad line."""
    n = 0
    meta = None
    first_content_line = True
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError as e:
            raise ValueError(f"trace line {lineno}: not JSON ({e})") from None
        if not isinstance(obj, dict):
            raise ValueError(f"trace line {lineno}: not an object")
        if META_KEY in obj:
            if not first_content_line:
                raise ValueError(
                    f"trace line {lineno}: {META_KEY} only allowed as the first line"
                )
            if not isinstance(obj[META_KEY], dict):
                raise ValueError(f"trace line {lineno}: {META_KEY} is not an object")
            meta = obj[META_KEY]
            first_content_line = False
            continue
        first_content_line = False
        for key in _RESERVED:
            if key not in obj:
                raise ValueError(f"trace line {lineno}: missing {key!r}")
        if not isinstance(obj["rid"], int) or obj["rid"] < 0:
            raise ValueError(f"trace line {lineno}: bad rid {obj['rid']!r}")
        if not isinstance(obj["span"], str) or not obj["span"]:
            raise ValueError(f"trace line {lineno}: bad span {obj['span']!r}")
        t0, t1 = obj["t0"], obj["t1"]
        if not isinstance(t0, (int, float)) or not isinstance(t1, (int, float)):
            raise ValueError(f"trace line {lineno}: non-numeric t0/t1")
        if t1 < t0:
            raise ValueError(f"trace line {lineno}: t1 < t0 ({t1} < {t0})")
        n += 1
    return TraceCheck(n, meta)
