"""PyTorch port, trace replay: ``obs/replay.py``, ``obs/costmodel.py``,
``obs/autotune.py`` and ``launch/tune.py`` against the JAX package's on the
same JSONL traces.

Three traces: one made as ``tests/test_replay.py``'s ``synth_trace`` makes
it, one the port's frontend benchmark mirror writes
(``benchmarks/frontend_load_torch.py --smoke --device cpu --trace-out``)
and one the port's training CLI writes (``--trace-out``). On each: equal
``fit`` fingerprints (and canonical forms), equal ``train_stage_breakdown``
samples, equal ``simulate`` predictions for the same params and seed, and
equal ``recommend`` records; the port's tune CLI writes the same
recommendation and calibration record as the JAX CLI and passes or fails
the calibration gate alike; ``--config-from`` with the port's
recommendation sets the knobs the JAX benchmarks set in both mirrors.

The frontend mirror runs with its timing gates opened (``--min-ratio 0
--max-trace-overhead 1.0``): a shared CPU host cannot hold them; its trace
and benchmark record are what this file needs.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.launch.tune import main as jax_tune_main
from repro.obs.autotune import recommend as jax_recommend
from repro.obs.costmodel import StackParams as JStackParams
from repro.obs.costmodel import simulate as jax_simulate
from repro.obs.replay import fit_trace as jax_fit_trace
from repro.obs.replay import load_trace as jax_load_trace
from repro.obs.replay import train_stage_breakdown as jax_breakdown
from repro_torch.launch.tune import load_recommended_knobs
from repro_torch.launch.tune import main as tune_main
from repro_torch.obs.autotune import recommend
from repro_torch.obs.costmodel import StackParams, simulate
from repro_torch.obs.replay import fit_trace, load_trace, train_stage_breakdown
from test_replay import synth_trace

REPO = Path(__file__).resolve().parents[1]
TRACES = ("synth", "frontend", "train")
SERVING = ("synth", "frontend")
PARAMS = [{}, {"max_batch": 4, "pipeline_depth": 1}, {"coalesce_ms": 0.0, "queue_limit": 4, "cache_scale": 0.5},
          {"wave_per_session": 8, "cache_scale": 2.0}]


def _run(argv, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, *argv], cwd=cwd, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, (out.stdout + out.stderr)[-4000:]
    return out.stdout


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """{name: (trace path, measured benchmark record path or None)}."""
    tmp = tmp_path_factory.mktemp("traces")
    synth = tmp / "synth.jsonl"
    synth.write_text(synth_trace())
    fe = tmp / "frontend.jsonl"
    _run([str(REPO / "benchmarks" / "frontend_load_torch.py"), "--smoke", "--device", "cpu", "--min-ratio", "0",
          "--max-trace-overhead", "1.0", "--trace-out", str(fe), "--out", str(tmp / "BENCH_frontend.json")], tmp)
    train = tmp / "train.jsonl"
    _run(["-m", "repro_torch.launch.train", "--device", "cpu", "--volume-res", "32", "--max-points", "300",
          "--res", "32", "--steps", "4", "--views", "2", "--batch", "2", "--k-per-tile", "64",
          "--trace-out", str(train)], tmp)
    return {"synth": (synth, None), "frontend": (fe, tmp / "BENCH_frontend.json"), "train": (train, None)}


@pytest.mark.parametrize("name", TRACES)
def test_fit_gives_the_jax_fingerprint(traces, name):
    path = str(traces[name][0])
    got, want = fit_trace(path), jax_fit_trace(path)
    assert got.to_dict() == want.to_dict()
    assert got.fingerprint() == want.fingerprint()
    assert (len(got.arrivals) > 0) == (name in SERVING)


@pytest.mark.parametrize("name", TRACES)
def test_train_stage_breakdown_equals_jax(traces, name):
    path = str(traces[name][0])
    got, want = train_stage_breakdown(load_trace(path)[1]), jax_breakdown(jax_load_trace(path)[1])
    assert got.keys() == want.keys()
    assert got.pop("timesteps") == want.pop("timesteps")
    assert {k: v.samples for k, v in got.items()} == {k: v.samples for k, v in want.items()}
    if name == "train":
        assert {"batch", "dispatch", "device", "eval"} <= got.keys() and len(got["device"].samples) == 4


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", SERVING)
def test_simulate_predicts_as_jax(traces, name, seed):
    path = str(traces[name][0])
    got_model, want_model = fit_trace(path), jax_fit_trace(path)
    for knobs in PARAMS:
        p = StackParams(**{**StackParams.from_knobs(got_model.knobs).to_dict(), **knobs})
        q = JStackParams(**{**JStackParams.from_knobs(want_model.knobs).to_dict(), **knobs})
        assert p.to_dict() == q.to_dict()
        got = simulate(got_model, p, seed=seed)
        assert got == jax_simulate(want_model, q, seed=seed), knobs
        assert got["served"] + got["shed"] == len(got_model.arrivals)


@pytest.mark.parametrize("name", SERVING)
def test_recommend_equals_jax(traces, name):
    path = str(traces[name][0])
    got = recommend(fit_trace(path), seed=1, slo_p99_ms=50.0)
    assert got == jax_recommend(jax_fit_trace(path), seed=1, slo_p99_ms=50.0)
    assert got["evaluated"] > 100


def _tune(main, argv) -> str | None:
    """Run a tune CLI; its calibration gate's message, or None if it passed."""
    try:
        main(argv)
    except SystemExit as e:
        return str(e)
    return None


@pytest.mark.parametrize("name", SERVING)
def test_tune_cli_writes_the_jax_recommendation(traces, name, tmp_path):
    path, measured = traces[name]
    if measured is None:  # the synthetic trace: a record near what it replays to
        base = simulate(fit_trace(str(path)), StackParams.from_knobs(fit_trace(str(path)).knobs))
        measured = tmp_path / "measured.json"
        measured.write_text(json.dumps({"metrics": {"frames_per_s": base["frames_per_s"] * 1.05,
                                                    "p99_ms": base["p99_ms"]}}))
    verdicts = {}
    for pkg, main in (("port", tune_main), ("jax", jax_tune_main)):
        d = tmp_path / pkg
        verdicts[pkg] = _tune(main, ["--trace", str(path), "--seed", "2", "--out", str(d / "RECOMMEND.json"),
                                     "--measured", str(measured), "--bench-out", str(d / "BENCH_replay.json")])
    assert verdicts["port"] == verdicts["jax"]
    for f in ("RECOMMEND.json", "BENCH_replay.json"):
        assert json.loads((tmp_path / "port" / f).read_text()) == json.loads((tmp_path / "jax" / f).read_text())
    if name == "synth":
        assert verdicts["port"] is None  # 5% off the replay: inside the 0.2 budget


def _mirror(name: str):
    sys.path.insert(0, str(REPO / "benchmarks"))
    spec = importlib.util.spec_from_file_location(name, REPO / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the knobs each JAX benchmark takes from --config-from
# (benchmarks/serve_throughput.py:131-138, benchmarks/frontend_load.py:246-257)
MIRRORS = {"serve_throughput_torch": ("max_batch", "pipeline_depth"),
           "frontend_load_torch": ("coalesce_ms", "max_batch", "pipeline_depth", "queue_limit", "wave_per_session")}


@pytest.mark.parametrize("mirror", list(MIRRORS))
def test_config_from_sets_the_recommended_knobs(mirror, tmp_path, capsys):
    rec = tmp_path / "RECOMMEND.json"
    knobs = {"coalesce_ms": 4.0, "max_batch": 4, "pipeline_depth": 3, "queue_limit": 16, "wave_per_session": 2,
             "cache_scale": 0.5}
    rec.write_text(json.dumps({"recommended": {"knobs": knobs}}))
    assert load_recommended_knobs(str(rec)) == knobs
    args = argparse.Namespace(config_from=str(rec), coalesce_ms=2.0, max_batch=8, pipeline_depth=2, queue_limit=8,
                              wave_per_session=4)
    defaults = vars(args).copy()
    _mirror(mirror).config_from(args)
    for k, v in vars(args).items():
        want = knobs[k] if k in MIRRORS[mirror] else defaults[k]
        assert v == want and type(v) is type(defaults[k]), (k, v)
    line = capsys.readouterr().out.strip()
    assert line.startswith(f"config-from {rec}:") and all(f"{k}={getattr(args, k)}" in line for k in MIRRORS[mirror])
