"""Trace-driven replay, part 3: knob-space search over the simulator
(a copy of the JAX package's ``obs/autotune.py``).

``recommend(model)`` grid-searches :class:`~repro_torch.obs.costmodel.StackParams`
space by replaying the fitted trace under every candidate and returns the
best predicted configuration next to the recorded-knob baseline. The search
is deliberately a small exhaustive grid (a few hundred candidates, each a
sub-millisecond pure-Python replay) rather than anything adaptive: the
simulator is deterministic, so an exhaustive sweep IS the global optimum of
the modeled space, and the result is bit-reproducible — the property the
``launch.tune`` CLI and its tests pin via the model fingerprint.

Ranking: feasibility first (when an SLO target is given, candidates whose
predicted p99 exceeds it sort below every feasible one), then predicted
throughput, then lower p99, then fewer sheds. Ties break toward the
*baseline-most* candidate by sorted knob order — strictly-better comparison
(``>``), so iteration order can never flip a recommendation between runs.
"""
from __future__ import annotations

import itertools

from repro_torch.obs.costmodel import StackParams, simulate
from repro_torch.obs.replay import CostModel

__all__ = ["DEFAULT_GRID", "recommend"]

# Small on purpose: every value here is one the serving stack is known to
# accept, and the --config-from consumers re-run for real under the winner,
# so the grid's job is coverage of the knee points, not fine resolution.
DEFAULT_GRID = {
    "coalesce_ms": (0.0, 1.0, 2.0, 4.0),
    "max_batch": (4, 8),
    "pipeline_depth": (1, 2, 3),
    "queue_limit": (4, 8, 16),
    "wave_per_session": (2, 4, 8),
}


def _score(pred: dict, slo_p99_ms: float | None) -> tuple:
    feasible = slo_p99_ms is None or pred["p99_ms"] <= slo_p99_ms
    return (feasible, pred["frames_per_s"], -pred["p99_ms"], -pred["shed"])


def recommend(
    model: CostModel,
    *,
    seed: int = 0,
    grid: dict | None = None,
    slo_p99_ms: float | None = None,
) -> dict:
    """Search the knob grid via replay; returns a self-describing
    recommendation record (baseline + winner + predicted numbers), stamped
    with the model fingerprint so a consumer can tell which trace and fit
    produced it."""
    grid = dict(DEFAULT_GRID if grid is None else grid)
    baseline_params = StackParams.from_knobs(model.knobs)
    baseline = simulate(model, baseline_params, seed=seed)

    best_params, best_pred = baseline_params, baseline
    best_score = _score(baseline, slo_p99_ms)
    evaluated = 1
    keys = sorted(grid)
    for combo in itertools.product(*(sorted(grid[k]) for k in keys)):
        candidate = StackParams(**{
            **baseline_params.to_dict(), **dict(zip(keys, combo)),
        })
        if candidate == baseline_params:
            continue  # already scored as the baseline
        pred = simulate(model, candidate, seed=seed)
        evaluated += 1
        score = _score(pred, slo_p99_ms)
        if score > best_score:  # strictly better: order-stable determinism
            best_params, best_pred, best_score = candidate, pred, score

    return {
        "schema": 1,
        "seed": seed,
        "model_fingerprint": model.fingerprint(),
        "trace": {
            "requests": len(model.arrivals),
            "spans": model.span_count,
            "dropped": int(model.meta.get("dropped", 0)),
            "outcome_mix": model.outcome_mix(),
        },
        "slo_p99_ms": slo_p99_ms,
        "baseline": {
            "knobs": baseline_params.to_dict(),
            "predicted": baseline,
        },
        "recommended": {
            "knobs": best_params.to_dict(),
            "predicted": best_pred,
        },
        "predicted_speedup": round(
            best_pred["frames_per_s"] / max(baseline["frames_per_s"], 1e-9), 3
        ),
        "evaluated": evaluated,
        "grid": {k: list(grid[k]) for k in keys},
    }
