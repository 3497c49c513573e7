"""Trace-driven replay, part 1: load span JSONL and fit a stage cost model
(a copy of the JAX package's ``obs/replay.py``: the same JSONL gives the
same model, and the same ``fingerprint()``, in both packages).

Input is the ``--trace-out`` export format (see ``obs.export``): one span per
line, joined into per-request trees by ``rid``. From one trace this module
extracts the two things a what-if simulation needs:

**The arrival timeline** — every request's admit time (relative to the first
admit), session, stream/timestep, and its *recorded cache outcome* (``miss``
/ ``full_hit`` / ``cache_hit`` / ``partial_hit`` / ``dedup`` / ``shed``).
Replaying the *recorded* arrivals (instead of synthesizing Poisson traffic)
is the point: the timeline embeds the real clients' request-ahead pacing,
scrub bursts, and think time, which is exactly what makes knob predictions
transfer back to the stack that produced the trace.

**Stage cost distributions** — empirical duration samples per pipeline
stage. The one subtle fit is device render cost: under ``pipeline_depth >=
2`` consecutive ``render`` spans *overlap* (batch N+1 dispatches while batch
N is still on device), so raw span durations double-count device time.
Batch events are therefore reduced to **exclusive** service time — sorted by
dispatch, each batch is charged ``t1 - max(t0, busy_until)`` — mirroring how
the server's own ``render_s`` counter accounts pipelined waves. Batch cost
is then fit as ``a + b * batch_size`` (least squares) when the trace covers
more than one batch size, with the empirical per-size scatter kept so the
simulator can replay realistic variance rather than a flat mean.

The fit is pure arithmetic over sorted inputs — no RNG — so the same trace
always yields the same model, and ``fingerprint()`` (sha1 of the canonical
JSON form) is the identity the autotuner stamps on its recommendations.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json

from repro_torch.obs.export import validate_trace_jsonl
from repro_torch.obs.trace import LOOP_STAGES

__all__ = [
    "load_trace",
    "build_trees",
    "fit",
    "fit_trace",
    "train_stage_breakdown",
    "CostModel",
    "StageDist",
    "OUTCOMES",
]

# recorded submit outcomes; "shed" comes from the shed span, "unknown" marks
# a request whose tree lost its submit span (ring overwrite / truncation)
OUTCOMES = ("miss", "full_hit", "cache_hit", "partial_hit", "dedup", "shed", "unknown")

# outcomes that resolve without a device batch
HIT_OUTCOMES = frozenset({"full_hit", "cache_hit", "dedup"})


def load_trace(source: str) -> tuple[dict, list[dict]]:
    """Load a span JSONL trace from a path (or raw JSONL text — anything
    containing a newline or brace is treated as text). Validates the
    contract first; returns ``(meta, records)`` where ``meta`` is the
    ``trace_meta`` header (possibly empty) and each record is one span
    dict."""
    if "\n" in source or source.lstrip().startswith("{"):
        text = source
    else:
        with open(source) as f:
            text = f.read()
    check = validate_trace_jsonl(text)  # raises on any malformed line
    records = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        obj = json.loads(line)
        if "trace_meta" in obj:
            continue
        records.append(obj)
    return dict(check.meta), records


def build_trees(records: list[dict]) -> dict[int, dict[str, list[dict]]]:
    """Group spans into per-request trees: ``{rid: {stage: [span, ...]}}``,
    spans within a stage ordered by t0."""
    trees: dict[int, dict[str, list[dict]]] = {}
    for r in sorted(records, key=lambda r: (r["t0"], r["t1"])):
        trees.setdefault(r["rid"], {}).setdefault(r["span"], []).append(r)
    return trees


@dataclasses.dataclass
class StageDist:
    """Empirical duration distribution for one stage (seconds, sorted)."""

    samples: list

    @property
    def count(self) -> int:
        return len(self.samples)

    @property
    def mean(self) -> float:
        return sum(self.samples) / len(self.samples) if self.samples else 0.0

    def percentile(self, q: float) -> float:
        if not self.samples:
            return 0.0
        idx = min(int(q / 100.0 * len(self.samples)), len(self.samples) - 1)
        return self.samples[idx]

    def sample(self, rng) -> float:
        """One draw from the empirical distribution (deterministic under a
        seeded rng); 0 when the trace never exercised this stage."""
        if not self.samples:
            return 0.0
        return self.samples[rng.randrange(len(self.samples))]

    def to_dict(self) -> dict:
        return {
            "count": self.count,
            "mean_ms": round(self.mean * 1e3, 6),
            "p50_ms": round(self.percentile(50) * 1e3, 6),
            "p99_ms": round(self.percentile(99) * 1e3, 6),
            "samples": [round(s, 9) for s in self.samples],
        }


def _linear_fit(points: list[tuple[float, float]]) -> tuple[float, float]:
    """Least-squares ``y = a + b x`` (b clamped >= 0; falls back to a flat
    mean when x never varies)."""
    n = len(points)
    xs = [p[0] for p in points]
    ys = [p[1] for p in points]
    mx = sum(xs) / n
    my = sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    if sxx <= 1e-12:  # one batch size observed: no slope information
        return my, 0.0
    b = max(sum((x - mx) * (y - my) for x, y in points) / sxx, 0.0)
    return my - b * mx, b


@dataclasses.dataclass
class CostModel:
    """Everything a discrete-event replay needs, fit from one trace."""

    meta: dict                      # trace_meta header (knobs, drop counts)
    arrivals: list                  # [{t, rid, session, stream, timestep,
                                    #   outcome, missing_tiles, bulk}] by t
    batch_sizes: dict               # {batch_size: StageDist of exclusive s}
    batch_fit: tuple                # (a, b): device cost ~= a + b * size
    partial: "StageDist"            # exclusive partial-render (row) jobs
    submit: dict                    # {outcome: StageDist} submit overhead
    host: "StageDist"               # per-request retire + assemble
    encode: "StageDist"             # per-frame wire encode
    write: "StageDist"              # per-frame socket write
    span_count: int = 0

    @property
    def knobs(self) -> dict:
        """The serving-stack configuration that produced the trace (empty
        when the exporter wasn't given any)."""
        return dict(self.meta.get("knobs") or {})

    @property
    def duration_s(self) -> float:
        return self.arrivals[-1]["t"] if self.arrivals else 0.0

    def outcome_mix(self) -> dict:
        mix = dict.fromkeys(OUTCOMES, 0)
        for a in self.arrivals:
            mix[a["outcome"]] += 1
        return {k: v for k, v in mix.items() if v}

    def batch_cost(self, size: int, rng) -> float:
        """Predicted exclusive device cost of one batch of ``size``.

        Mean-field on purpose: the least-squares fit integrates to exactly
        the observed total device time over the recorded batch mix, so
        using it directly keeps aggregate predictions calibrated even when
        per-size scatter is wild (a contended host makes a size-4 batch
        occasionally cost more than a size-8 one — resampling that scatter
        onto a different batch decomposition inflated predictions by 30%+).
        ``rng`` stays in the signature for cost models that do carry
        usable variance."""
        size = max(int(size), 1)
        a, b = self.batch_fit
        if b > 0.0:
            return max(a + b * size, 0.0)
        if not self.batch_sizes:
            return max(a, 0.0)
        # one batch size observed: no slope information — assume half the
        # cost is fixed dispatch overhead and half scales with views (the
        # vmap prior) so a max_batch what-if still moves in a sane direction
        nearest = min(self.batch_sizes, key=lambda s: (abs(s - size), s))
        mean = self.batch_sizes[nearest].mean
        return max(mean * (0.5 + 0.5 * size / nearest), 0.0)

    def to_dict(self) -> dict:
        return {
            "schema": 1,
            "meta": self.meta,
            "span_count": self.span_count,
            "requests": len(self.arrivals),
            "duration_s": round(self.duration_s, 6),
            "outcome_mix": self.outcome_mix(),
            "arrivals": [
                {**a, "t": round(a["t"], 9)} for a in self.arrivals
            ],
            "batch_fit": {
                "base_s": round(self.batch_fit[0], 9),
                "per_view_s": round(self.batch_fit[1], 9),
            },
            "batch_sizes": {
                str(k): v.to_dict() for k, v in sorted(self.batch_sizes.items())
            },
            "stages": {
                "partial": self.partial.to_dict(),
                "host": self.host.to_dict(),
                "encode": self.encode.to_dict(),
                "write": self.write.to_dict(),
                **{f"submit:{k}": v.to_dict() for k, v in sorted(self.submit.items())},
            },
        }

    def fingerprint(self) -> str:
        """sha1 of the canonical JSON form — the replay-determinism anchor
        (same trace => same model => same fingerprint)."""
        blob = json.dumps(self.to_dict(), sort_keys=True, separators=(",", ":"))
        return hashlib.sha1(blob.encode()).hexdigest()


def _exclusive(events: list[tuple[float, float]]) -> list[float]:
    """Exclusive service times of possibly-overlapping events, in dispatch
    order: each is charged only the wall it added beyond its predecessors
    (``t1 - max(t0, busy_until)``) — the server's render_s accounting."""
    out = []
    busy = float("-inf")
    for t0, t1 in sorted(events):
        out.append(max(t1 - max(t0, busy), 0.0))
        busy = max(busy, t1)
    return out


def fit(meta: dict, records: list[dict]) -> CostModel:
    """Fit a :class:`CostModel` from validated span records (see module
    docstring for what is extracted and how overlap is handled)."""
    trees = build_trees(records)

    arrivals = []
    submit_events: list[tuple[float, float, str]] = []
    host_samples: list[float] = []
    encode_samples: list[float] = []
    write_samples: list[float] = []
    # batch render events dedupe on (t0, t1): every request in one batch
    # records an identical render span (same dispatch, same retire drain)
    batch_events: dict[tuple, int] = {}
    partial_events: dict[tuple, int] = {}

    for rid in sorted(trees):
        tree = trees[rid]
        admit = tree.get("admit") or tree.get("coalesce") or tree.get("submit")
        if not admit:
            continue  # a tree with no entry point can't be replayed
        submits = tree.get("submit")
        if "shed" in tree:
            outcome = "shed"
        elif submits:
            outcome = submits[0].get("outcome", "unknown")
            if outcome not in OUTCOMES:
                outcome = "unknown"
        else:
            outcome = "unknown"
        arrivals.append({
            "t": admit[0]["t0"],
            "rid": rid,
            "session": admit[0].get("session", 0),
            "stream": admit[0].get("stream", ""),
            "timestep": admit[0].get("timestep", 0),
            "outcome": outcome,
            "missing_tiles": (submits[0].get("missing_tiles", 0) if submits else 0),
            "bulk": bool(admit[0].get("bulk", False)),
        })
        if submits:
            # submit spans start at *admit* time (the gateway passes
            # t_submit=t_admit so the server keeps one latency origin), so
            # the raw duration embeds coalesce/queue wait the simulator
            # already models; floor each span at its wave cut and charge
            # exclusive service below
            coalesce = tree.get("coalesce")
            cut = coalesce[-1]["t1"] if coalesce else submits[0]["t0"]
            submit_events.append(
                (max(submits[0]["t0"], cut), submits[0]["t1"], outcome)
            )
        host = 0.0
        for stage in ("retire", "assemble"):
            for s in tree.get(stage, ()):
                host += max(s["t1"] - s["t0"], 0.0)
        if "render" in tree and outcome in ("miss", "unknown"):
            host_samples.append(host)
        for s in tree.get("encode", ()):
            encode_samples.append(max(s["t1"] - s["t0"], 0.0))
        for s in tree.get("write", ()):
            write_samples.append(max(s["t1"] - s["t0"], 0.0))
        for s in tree.get("render", ()):
            key = (round(s["t0"], 9), round(s["t1"], 9))
            if s.get("partial"):
                partial_events[key] = int(s.get("rows", 1))
            else:
                batch_events[key] = int(s.get("batch", 1))

    arrivals.sort(key=lambda a: (a["t"], a["rid"]))
    t0 = arrivals[0]["t"] if arrivals else 0.0
    for a in arrivals:
        a["t"] -= t0

    # exclusive device cost per batch, bucketed by batch size
    excl = _exclusive(list(batch_events))
    sizes: dict[int, list] = {}
    points = []
    for (key, size), e in zip(sorted(batch_events.items()), excl):
        sizes.setdefault(size, []).append(e)
        points.append((float(size), e))
    batch_fit = _linear_fit(points) if points else (0.0, 0.0)

    partial_excl = _exclusive(list(partial_events))

    # submits within one wave share a start (the admit) and run back to
    # back; exclusive accounting recovers each one's marginal CPU cost
    submit_samples: dict[str, list] = {}
    busy = float("-inf")
    for s0, s1, out in sorted(submit_events):
        submit_samples.setdefault(out, []).append(max(s1 - max(s0, busy), 0.0))
        busy = max(busy, s1)

    def dist(samples) -> StageDist:
        return StageDist(sorted(round(s, 9) for s in samples))

    return CostModel(
        meta=dict(meta),
        arrivals=arrivals,
        batch_sizes={k: dist(v) for k, v in sorted(sizes.items())},
        batch_fit=batch_fit,
        partial=dist(partial_excl),
        submit={k: dist(v) for k, v in sorted(submit_samples.items())},
        host=dist(host_samples),
        encode=dist(encode_samples),
        write=dist(write_samples),
        span_count=len(records),
    )


def fit_trace(source: str) -> CostModel:
    """``load_trace`` + ``fit`` in one call (path or raw JSONL text)."""
    meta, records = load_trace(source)
    return fit(meta, records)


def train_stage_breakdown(records: list[dict]) -> dict:
    """Per-stage duration distributions for the TRAINING span vocabulary.

    A training trace uses one rid per stream timestep (or fit call), so the
    serving ``fit()`` — which wants admit/submit trees — has nothing to say
    about it; this is the training-side analog: ``{stage: StageDist}`` over
    the :data:`~repro_torch.obs.trace.LOOP_STAGES` names found in ``records``
    (seconds, sorted), plus a ``"timesteps"`` entry counting distinct rids
    that carried training spans. Stage names outside the training loop's
    vocabulary are ignored, so a mixed training+serving trace (one shared
    Obs) feeds this AND ``fit()`` from the same file; the train step's own
    stages (``STEP_STAGES``) are left out too, so the result is the JAX
    package's on the same file."""
    train = frozenset(LOOP_STAGES)
    samples: dict[str, list] = {}
    rids = set()
    for r in records:
        if r["span"] not in train:
            continue
        rids.add(r["rid"])
        samples.setdefault(r["span"], []).append(max(r["t1"] - r["t0"], 0.0))
    out = {
        stage: StageDist(sorted(round(s, 9) for s in got))
        for stage, got in samples.items()
    }
    out["timesteps"] = len(rids)
    return out
