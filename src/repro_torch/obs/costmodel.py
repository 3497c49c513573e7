"""Trace-driven replay, part 2: discrete-event simulation of the stack
(a copy of the JAX package's ``obs/costmodel.py``: the same model, params
and seed give the same prediction in both packages).

``simulate(model, params)`` replays a fitted :class:`~repro_torch.obs.replay.
CostModel`'s recorded arrival timeline against a parameterized model of the
serving stack and predicts fps / p50 / p99 / shed-rate **without touching a
device**. The simulated control flow mirrors the real gateway loop
(``frontend/gateway.py``) stage for stage:

* arrivals land in per-session bounded queues; overflow sheds the oldest
  entry (the gateway's admission control, ``queue_limit``);
* the dispatcher coalesces — waits up to ``coalesce_ms`` for queued work to
  reach a device micro-batch, admitting arrivals that land inside the
  window — then cuts a *wave*: up to ``wave_per_session`` requests per
  session, round-robin;
* the wave runs on the (single) render executor: cache-resolved requests
  pay only their recorded submit overhead, partial hits pay the fitted
  row-render cost, and misses group into micro-batches by (stream,
  timestep) capped at ``max_batch`` — batches flow through a depth-bounded
  device/host pipeline (device renders batch N+1 while host postprocesses
  batch N when ``pipeline_depth >= 2``), the same overlap the engine's
  in-flight ring provides;
* waves serialize on the render executor (the dispatcher awaits it), while
  delivery (encode + socket write per frame) runs in a chained background
  task overlapping the next wave's render — ``deliver_start = max(wave_end,
  prev_deliver_end)``.

Because arrivals replay at their *recorded* times, predicted throughput is
capped by the recorded offered load — the simulator answers "what would
these same clients have experienced under different knobs", which is the
question autotuning actually needs answered (and what makes self-calibration
meaningful: identical knobs must reproduce the measured numbers).

Determinism: a fresh ``random.Random(seed)`` per call, dict iteration over
sorted keys only. Same model + params + seed => identical prediction.
"""
from __future__ import annotations

import collections
import dataclasses
import random

from repro_torch.obs.replay import HIT_OUTCOMES, CostModel

__all__ = ["StackParams", "simulate"]


@dataclasses.dataclass(frozen=True)
class StackParams:
    """The knob vector a what-if run perturbs (gateway + engine tiers)."""

    coalesce_ms: float = 2.0     # dispatcher wave-coalesce window
    max_batch: int = 8           # engine micro-batch cap
    pipeline_depth: int = 2      # engine in-flight ring depth
    queue_limit: int = 8         # per-session admission queue (shed beyond)
    wave_per_session: int = 4    # dispatcher per-session wave quota
    cache_scale: float = 1.0     # <1 demotes recorded hits to misses
                                 # (a smaller cache); >1 promotes misses

    @classmethod
    def from_knobs(cls, knobs: dict) -> "StackParams":
        """Build from a recorded ``trace_meta.knobs`` dict, ignoring keys
        the simulator doesn't model (res, clients, ...)."""
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in dict(knobs).items() if k in fields})

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _percentile(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(int(q / 100.0 * len(sorted_vals)), len(sorted_vals) - 1)
    return sorted_vals[idx]


def simulate(model: CostModel, params: StackParams, *, seed: int = 0) -> dict:
    """Replay ``model``'s arrival timeline under ``params``; returns
    ``{frames_per_s, p50_ms, p99_ms, served, shed, shed_rate, waves,
    mean_batch, wall_s}``."""
    rng = random.Random(seed)
    n = len(model.arrivals)
    if n == 0:
        return {"frames_per_s": 0.0, "p50_ms": 0.0, "p99_ms": 0.0, "served": 0,
                "shed": 0, "shed_rate": 0.0, "waves": 0, "mean_batch": 0.0,
                "wall_s": 0.0}

    # --- outcome reassignment under the cache what-if axis. Recorded sheds
    # replay as misses (whether THIS knob set sheds them is the simulator's
    # decision); a lost submit span ("unknown") is conservatively a miss.
    arrivals = []
    for a in model.arrivals:
        outcome = a["outcome"]
        if outcome in ("shed", "unknown"):
            outcome = "miss"
        if params.cache_scale < 1.0 and outcome in HIT_OUTCOMES | {"partial_hit"}:
            if rng.random() >= params.cache_scale:
                outcome = "miss"
        elif params.cache_scale > 1.0 and outcome == "miss":
            if rng.random() < 1.0 - 1.0 / params.cache_scale:
                outcome = "full_hit"
        arrivals.append({**a, "outcome": outcome})

    coalesce_s = max(params.coalesce_ms, 0.0) / 1e3
    queues: dict = collections.defaultdict(collections.deque)
    i = 0                       # next unadmitted arrival
    shed = 0
    latencies: list[float] = []
    t = arrivals[0]["t"]
    deliver_free = t
    waves = 0
    batch_count = 0
    batch_total = 0
    last_completion = t

    def admit_until(limit_t: float) -> None:
        nonlocal i, shed
        while i < n and arrivals[i]["t"] <= limit_t:
            a = arrivals[i]
            q = queues[a["session"]]
            if len(q) >= params.queue_limit:
                q.popleft()     # oldest-drop shed (gateway admission control)
                shed += 1
            q.append(a)
            i += 1

    def queued() -> int:
        return sum(len(q) for q in queues.values())

    while True:
        admit_until(t)
        if queued() == 0:
            if i >= n:
                break
            t = arrivals[i]["t"]
            continue
        # --- coalesce: hold the wave until a device micro-batch's worth is
        # queued or the window expires, admitting arrivals that land inside
        if coalesce_s > 0 and queued() < params.max_batch:
            deadline = t + coalesce_s
            while (i < n and arrivals[i]["t"] <= deadline
                   and queued() < params.max_batch):
                t = max(t, arrivals[i]["t"])
                admit_until(t)
            if queued() < params.max_batch:
                t = deadline  # window expired without filling a batch
        # --- cut the wave: per-session quota, sessions in sorted order
        wave = []
        for sid in sorted(queues):
            q = queues[sid]
            for _ in range(min(params.wave_per_session, len(q))):
                wave.append(q.popleft())
        waves += 1
        # --- render executor: submit overhead + partial jobs serially,
        # then miss batches through the depth-bounded device/host pipeline
        cursor = t
        batches: dict = collections.defaultdict(list)
        for a in wave:
            sub = model.submit.get(a["outcome"]) or model.submit.get("miss")
            if sub is not None:
                cursor += sub.sample(rng)
            if a["outcome"] in HIT_OUTCOMES:
                continue
            if a["outcome"] == "partial_hit":
                cursor += model.partial.sample(rng)
                continue
            batches[(a["stream"], a["timestep"])].append(a)
        dev_free = host_free = cursor
        host_done: list[float] = []
        k = 0
        for key in sorted(batches):
            group = batches[key]
            for j in range(0, len(group), params.max_batch):
                chunk = group[j:j + params.max_batch]
                batch_count += 1
                batch_total += len(chunk)
                dev_start = dev_free
                if k >= params.pipeline_depth:
                    # the in-flight ring slot frees when the host finishes
                    # the batch ``depth`` places back
                    dev_start = max(dev_start, host_done[k - params.pipeline_depth])
                dev_end = dev_start + model.batch_cost(len(chunk), rng)
                dev_free = dev_end
                host_cost = sum(model.host.sample(rng) for _ in chunk)
                host_end = max(dev_end, host_free) + host_cost
                host_free = host_end
                host_done.append(host_end)
                k += 1
        wave_end = host_free
        # --- delivery chain: overlaps the next wave's render, serialized
        # behind the previous wave's delivery
        deliver = max(wave_end, deliver_free)
        for a in wave:
            deliver += model.encode.sample(rng) + model.write.sample(rng)
            latencies.append(deliver - a["t"])
            last_completion = deliver
        deliver_free = deliver
        # the dispatcher awaits the render executor before the next wave
        t = wave_end

    served = len(latencies)
    wall = max(last_completion - arrivals[0]["t"], 1e-9)
    lat_ms = sorted(x * 1e3 for x in latencies)
    return {
        "frames_per_s": round(served / wall, 2),
        "p50_ms": round(_percentile(lat_ms, 50), 3),
        "p99_ms": round(_percentile(lat_ms, 99), 3),
        "served": served,
        "shed": shed,
        "shed_rate": round(shed / n, 4),
        "waves": waves,
        "mean_batch": round(batch_total / batch_count, 2) if batch_count else 0.0,
        "wall_s": round(wall, 6),
    }
