"""Trace-driven autotuning driver: fit, replay, recommend, calibrate (a copy
of the JAX package's ``launch/tune.py``, over the port's replay chain; the
same trace and seed write the same recommendation in both packages).

Closes the observe -> model -> decide loop over a recorded span trace:

  # record a trace (benchmarks/frontend_load_torch.py --trace-out, or either
  # serving CLI), then search the knob space via replay
  PYTHONPATH=src python -m repro_torch.launch.tune --trace TRACE_frontend.jsonl \
      --out RECOMMEND_tune.json

  # additionally self-calibrate against the measured benchmark record and
  # fail if the replay misses the measured fps/p99 by more than the budget
  PYTHONPATH=src python -m repro_torch.launch.tune --trace TRACE_frontend.jsonl \
      --measured BENCH_frontend.json --bench-out BENCH_replay.json

The recommendation JSON is consumed by ``benchmarks/serve_throughput_torch.py``
and ``benchmarks/frontend_load_torch.py`` via ``--config-from`` (see
:func:`load_recommended_knobs`). The whole pipeline is deterministic for a
fixed trace + ``--seed``: the recommendation embeds the cost-model
fingerprint so any consumer can verify which fit produced it.

Self-calibration is the honesty gate: replaying the trace under the very
knobs that produced it must predict aggregate fps and p99 close to the
*measured* numbers in the benchmark record (the traced lap's, when present).
A model that can't reproduce the world it watched has no business
recommending changes to it — CI enforces the budget via ``BENCH_replay.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def load_recommended_knobs(path: str) -> dict:
    """Read the knob dict out of a ``launch.tune`` recommendation file (or
    accept a bare ``{knob: value}`` JSON for hand-written configs) — the
    ``--config-from`` entry point for the benchmark drivers."""
    with open(path) as f:
        rec = json.load(f)
    if isinstance(rec, dict) and "recommended" in rec:
        return dict(rec["recommended"]["knobs"])
    if isinstance(rec, dict):
        return dict(rec)
    raise ValueError(f"{path}: not a recommendation file or knob dict")


def _measured_numbers(path: str) -> tuple[float, float, str]:
    """Pull measured (fps, p99_ms) from a BENCH_*.json record, preferring
    the traced lap's own numbers (``trace_frames_per_s``/``trace_p99_ms``)
    — that lap is the one the spans describe — over the best-lap
    headline metrics."""
    with open(path) as f:
        rec = json.load(f)
    metrics = rec.get("metrics", rec)
    if "trace_frames_per_s" in metrics:
        return (float(metrics["trace_frames_per_s"]),
                float(metrics.get("trace_p99_ms", metrics.get("p99_ms", 0.0))),
                "traced_lap")
    return float(metrics["frames_per_s"]), float(metrics["p99_ms"]), "best_lap"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", required=True, metavar="PATH.jsonl",
                    help="span trace exported by --trace-out")
    ap.add_argument("--seed", type=int, default=0,
                    help="replay seed (fixed trace + seed => fixed output)")
    ap.add_argument("--slo-p99-ms", type=float, default=None,
                    help="rank knob candidates under this p99 target "
                         "(infeasible ones lose to any feasible one)")
    ap.add_argument("--out", default="RECOMMEND_tune.json",
                    help="recommendation JSON (consumed via --config-from)")
    # self-calibration gate
    ap.add_argument("--measured", default=None, metavar="BENCH.json",
                    help="measured benchmark record to calibrate against")
    ap.add_argument("--bench-out", default=None, metavar="BENCH_replay.json",
                    help="write the predicted-vs-measured calibration record")
    ap.add_argument("--calibration-budget", type=float, default=0.2,
                    help="max relative error on fps AND p99 before failing")
    args = ap.parse_args(argv)

    # imported here so `--help` works without src on the path being warm
    from repro_torch.obs.autotune import recommend
    from repro_torch.obs.replay import fit_trace

    model = fit_trace(args.trace)
    dropped = int(model.meta.get("dropped", 0))
    if dropped:
        # fit on a lossy trace is fit on a lie — proceed (the model may
        # still be useful) but say so where nobody can miss it
        print(f"WARNING: trace dropped {dropped} spans to ring overwrite "
              f"(capacity {model.meta.get('capacity')}); the cost model is "
              f"fit on an incomplete record — re-record with a larger "
              f"--trace-capacity for trustworthy numbers", file=sys.stderr)
    print(f"model: {len(model.arrivals)} requests / {model.span_count} spans, "
          f"outcomes {model.outcome_mix()}, knobs {model.knobs or '(none recorded)'}, "
          f"fingerprint {model.fingerprint()[:12]}")

    rec = recommend(model, seed=args.seed, slo_p99_ms=args.slo_p99_ms)
    base, reco = rec["baseline"], rec["recommended"]
    print(f"baseline  {base['knobs']}\n"
          f"          -> {base['predicted']['frames_per_s']} fps, "
          f"p99 {base['predicted']['p99_ms']} ms, "
          f"shed {base['predicted']['shed']}")
    print(f"recommend {reco['knobs']}\n"
          f"          -> {reco['predicted']['frames_per_s']} fps, "
          f"p99 {reco['predicted']['p99_ms']} ms, "
          f"shed {reco['predicted']['shed']} "
          f"({rec['predicted_speedup']}x predicted, "
          f"{rec['evaluated']} candidates)")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"recommendation -> {args.out}")

    if args.measured is None:
        return

    # ---- self-calibration: predicted (recorded knobs) vs measured
    measured_fps, measured_p99, source = _measured_numbers(args.measured)
    pred = base["predicted"]
    fps_err = abs(pred["frames_per_s"] - measured_fps) / max(measured_fps, 1e-9)
    p99_err = abs(pred["p99_ms"] - measured_p99) / max(measured_p99, 1e-9)
    calibration_error = max(fps_err, p99_err)
    print(f"calibration vs {args.measured} ({source}): "
          f"fps {pred['frames_per_s']} vs {measured_fps} "
          f"(err {fps_err:.1%}), p99 {pred['p99_ms']} vs {measured_p99} ms "
          f"(err {p99_err:.1%}) -> {calibration_error:.1%} "
          f"(budget {args.calibration_budget:.0%})")
    if args.bench_out:
        # bench_schema lives in benchmarks/ (not on the package path);
        # the record shape is small enough to emit inline, same schema
        record = {
            "bench": "replay_calibration",
            "schema": 2,
            "config": {
                "trace": os.path.basename(args.trace),
                "seed": args.seed,
                "spans": model.span_count,
                "requests": len(model.arrivals),
                "dropped_spans": dropped,
                "measured_source": source,
                **{f"knob_{k}": v for k, v in sorted(base["knobs"].items())},
            },
            "metrics": {
                "predicted_frames_per_s": pred["frames_per_s"],
                "measured_frames_per_s": measured_fps,
                "fps_error": round(fps_err, 4),
                "predicted_p99_ms": pred["p99_ms"],
                "measured_p99_ms": measured_p99,
                "p99_error": round(p99_err, 4),
                "calibration_error": round(calibration_error, 4),
                "calibration_budget": args.calibration_budget,
                "predicted_speedup": rec["predicted_speedup"],
                "recommended_frames_per_s": reco["predicted"]["frames_per_s"],
            },
        }
        os.makedirs(os.path.dirname(args.bench_out) or ".", exist_ok=True)
        with open(args.bench_out, "w") as f:
            json.dump(record, f, indent=1)
        print(f"calibration record -> {args.bench_out}")
    if calibration_error > args.calibration_budget:
        raise SystemExit(
            f"replay calibration error {calibration_error:.1%} exceeds budget "
            f"{args.calibration_budget:.0%}: the cost model does not "
            f"reproduce the measured run it was fit on"
        )


if __name__ == "__main__":
    main()
