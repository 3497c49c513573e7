"""PyTorch port, span export and SLO tracking against the JAX package's:
``spans_to_jsonl`` / ``spans_to_chrome`` / ``write_trace`` give the same
text and files for the same spans, ``validate_trace_jsonl`` gives the same
verdicts, ``SLOTracker`` walks the same states over a scripted latency
series (with registry resets between windows), ``parse_slo_spec`` accepts
and refuses the same specs; and the port's serving, training, in situ and
frontend CLIs write ``--trace-out`` files that both packages' validators
accept."""
import json

import pytest

from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.obs import SLOTracker as JSLOTracker
from repro.obs import TraceRecorder as JTraceRecorder
from repro.obs import parse_slo_spec as jax_parse_slo_spec
from repro.obs import spans_to_chrome as jax_spans_to_chrome
from repro.obs import spans_to_jsonl as jax_spans_to_jsonl
from repro.obs import trace_meta as jax_trace_meta
from repro.obs import validate_trace_jsonl as jax_validate
from repro.obs import write_trace as jax_write_trace
from repro_torch.launch import frontend as frontend_cli
from repro_torch.launch import insitu as insitu_cli
from repro_torch.launch import serve_gs as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.obs import (
    MetricsRegistry,
    SLOTracker,
    TraceRecorder,
    parse_slo_spec,
    spans_to_chrome,
    spans_to_jsonl,
    trace_meta,
    validate_trace_jsonl,
    write_trace,
)


def _record(rec):
    """The same spans on either package's recorder: serving and training
    stages, an unknown stage, overlapping renders and a ring overflow."""
    rec.record(1, "admit", 10.0, 10.0, seq=0, stream="static", bulk=False)
    rec.record(1, "coalesce", 10.0, 10.002, wave=1, wave_size=3)
    for i in range(3):  # overlapping renders: sub-lanes
        rec.record(2 + i, "render", 10.1 + 0.05 * i, 10.3 + 0.05 * i, batch=4, level=0, timestep=i)
    rec.record(1, "encode", 10.31, 10.315, encoding="tiles8", bytes=123)
    rec.record(7, "fit", 11.0, 12.5, t_index=0, steps=20)
    rec.record(8, "mystery_stage", 12.0, 12.25, note="x")
    rec.record(9, "shed", 12.3, 12.4, terminated=True, seq=4)
    return rec


@pytest.mark.parametrize("capacity", [64, 5])
def test_span_export_equals_jax(capacity):
    ours, theirs = _record(TraceRecorder(capacity)), _record(JTraceRecorder(capacity))
    ts, js = ours.spans(), theirs.spans()
    meta_t = trace_meta(ours, knobs={"max_batch": 4, "coalesce_ms": 2.0})
    meta_j = jax_trace_meta(theirs, knobs={"max_batch": 4, "coalesce_ms": 2.0})
    assert meta_t == meta_j and meta_t["dropped"] == (0 if capacity == 64 else 4)
    assert spans_to_jsonl(ts, meta=meta_t) == jax_spans_to_jsonl(js, meta=meta_j)
    assert spans_to_jsonl(ts) == jax_spans_to_jsonl(js)
    assert spans_to_chrome(ts, meta=meta_t) == jax_spans_to_chrome(js, meta=meta_j)


def test_write_trace_files_equal_jax(tmp_path):
    spans_t, spans_j = _record(TraceRecorder()).spans(), _record(JTraceRecorder()).spans()
    a = write_trace(str(tmp_path / "port.jsonl"), spans_t, meta={"dropped": 0})
    b = jax_write_trace(str(tmp_path / "jax.jsonl"), spans_j, meta={"dropped": 0})
    assert a[1].endswith(".chrome.json")
    for pa, pb in zip(a, b):
        assert open(pa).read() == open(pb).read()


VALIDATE_CASES = [
    "",
    '{"rid": 1, "span": "a", "t0": 0, "t1": 1}\n',
    '{"trace_meta": {"dropped": 3, "capacity": 8, "knobs": {"q": 1}}}\n{"rid": 0, "span": "a", "t0": 1, "t1": 1}\n',
    '{"rid": -1, "span": "a", "t0": 0, "t1": 1}\n',
    '{"rid": 1, "t0": 0, "t1": 1}\n',
    '{"rid": 1, "span": "a", "t0": 2, "t1": 1}\n',
    '{"rid": 1, "span": "", "t0": 0, "t1": 1}\n',
    '{"rid": 1, "span": "a", "t0": "0", "t1": 1}\n',
    "not json\n",
    "[1, 2]\n",
    '{"rid": 1, "span": "a", "t0": 0, "t1": 1}\n{"trace_meta": {}}\n',
    '{"trace_meta": []}\n',
]


def _verdict(fn, text):
    try:
        n = fn(text)
    except ValueError as e:
        return ("error", str(e))
    return (int(n), n.meta, n.dropped, n.capacity, n.knobs)


@pytest.mark.parametrize("case", range(len(VALIDATE_CASES)))
def test_validate_trace_jsonl_verdicts_equal_jax(case):
    text = VALIDATE_CASES[case]
    assert _verdict(validate_trace_jsonl, text) == _verdict(jax_validate, text)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_slo_tracker_states_equal_jax_on_a_scripted_latency_series():
    """The same latencies, ticks and resets through both trackers: every
    report equal, and the series walks ok -> warn/breach -> ok as slow
    requests enter and age out of the window."""
    reports = {}
    for name, Reg, Tracker in (("port", MetricsRegistry, SLOTracker), ("jax", JMetricsRegistry, JSLOTracker)):
        reg, clock = Reg(), _Clock()
        h = reg.histogram("gateway.request_ms")
        tr = Tracker(reg, p99_ms=50.0, window_s=10.0, budget=0.05, clock=clock)
        out = [tr.report()]
        for step in range(30):
            clock.t = float(step)
            for k in range(10):
                slow = 8 <= step < 12 and k < 2 + (step - 8)
                h.observe(400.0 if slow else 5.0 + k)
            tr.tick()
            out.append(tr.report())
            if step == 20:
                reg.reset()  # a lap boundary: the tracker rebaselines
                out.append(tr.report())
        reports[name] = out
    assert reports["port"] == reports["jax"]
    states = [r["state"] for r in reports["port"]]
    assert "breach" in states and states[-1] == "ok" and states[0] == "ok"


@pytest.mark.parametrize("spec", ["p99_ms=250", "p99_ms=250,window_s=10,budget=0.05", " p99_ms = 1 , warn_burn=0.5 ",
                                  "window_s=3", "p99_ms=1,bogus=2", "p99_ms", ""])
def test_parse_slo_spec_equals_jax(spec):
    def verdict(fn):
        try:
            return fn(spec)
        except ValueError as e:
            return ("error", str(e))

    assert verdict(parse_slo_spec) == verdict(jax_parse_slo_spec)


CLI_CASES = {
    "serve_gs": (serve_cli, ["--smoke", "--device", "cpu", "--clients", "2", "--requests", "2", "--levels", "2"],
                 {"submit", "render", "retire"}),
    "train": (train_cli, ["--device", "cpu", "--volume-res", "32", "--max-points", "300", "--res", "32",
                          "--steps", "3", "--views", "2", "--batch", "2", "--k-per-tile", "64"],
              {"batch", "dispatch", "device", "eval", "ckpt"}),
    "insitu": (insitu_cli, ["--smoke", "--device", "cpu", "--timesteps", "2", "--cold-steps", "3",
                            "--warm-steps", "2", "--no-scrub"], {"extract", "fit", "ckpt"}),
    "frontend": (frontend_cli, ["--smoke", "--device", "cpu"], {"admit", "coalesce", "encode", "write"}),
}


@pytest.mark.parametrize("cli", list(CLI_CASES))
def test_cli_trace_out_is_valid_in_both_packages(cli, tmp_path, monkeypatch, capsys):
    module, argv, want_spans = CLI_CASES[cli]
    monkeypatch.chdir(tmp_path)  # the training CLI caches ground truth under the working directory
    path = tmp_path / f"{cli}.jsonl"
    extra = ["--ckpt", str(tmp_path / "ck")] if cli in ("train", "insitu") else []
    module.main([*argv, *extra, "--trace-out", str(path)])
    assert f"-> {path}" in capsys.readouterr().out
    text = path.read_text()
    n_t, n_j = validate_trace_jsonl(text), jax_validate(text)
    assert int(n_t) == int(n_j) > 0 and n_t.meta == n_j.meta and n_t.dropped == 0 and n_t.knobs
    names = {json.loads(line).get("span") for line in text.splitlines()[1:]}
    assert want_spans <= names, names
    chrome = json.loads((tmp_path / f"{cli}.chrome.json").read_text())
    assert sum(e["ph"] == "X" for e in chrome["traceEvents"]) == int(n_t)
