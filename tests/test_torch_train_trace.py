"""PyTorch port, the train step's own stage spans (``obs/steptrace.py``):
a traced ``GSTrainer.fit`` records every stage of its steps inside the
step's ``dispatch`` span (the backward's from the autograd thread too),
across gloo ranks as well; under ``torch.profiler`` each stage opens its
``gs.<stage>`` range with the recorder off; an untraced step's sites
allocate nothing; and the chrome export lays the step's lanes after the
JAX package's overflow lane, every JAX lane keeping its tid.

Tiny random scenes (256-512 Gaussians, 32 px), seconds each."""
import threading
import tracemalloc
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_ranks as TR
from repro.obs import STAGES as JSTAGES
from repro.obs import TRAIN_STAGES as JTRAIN_STAGES
from repro.obs import spans_to_chrome as jax_spans_to_chrome
from repro.obs.trace import Span as JSpan
from repro_torch.core import gaussians as G
from repro_torch.core import projection as P
from repro_torch.core import render as R
from repro_torch.core.config import GSConfig
from repro_torch.core.train import init_state
from repro_torch.launch.train import GSTrainer
from repro_torch.obs import LOOP_STAGES, STEP_STAGES, Obs, Span, TraceRecorder, spans_to_chrome, steptrace
from repro_torch.obs.export import LANE_STRIDE
from repro_torch.volume.cameras import orbit_cameras

RES, BATCH, STEPS = 32, 2, 2
CFG = dict(img_h=RES, img_w=RES, tile_h=16, tile_w=16, k_per_tile=32, batch_size=BATCH)
PER_VIEW = ("project", "sort", "bin", "raster", "vjp", "raster_bwd")
PER_STEP = ("loss", "backward", "adam")
MESH_ONLY = ("gather", "reduce")


def _scene(n: int, seed: int = 0) -> G.GaussianModel:
    """Random Gaussians around the origin, where the orbit cameras look."""
    r = np.random.default_rng(seed)
    pts = r.normal(0.0, 0.3, (n, 3)).astype(np.float32)
    g = G.init_from_points(pts, r.uniform(0, 1, (n, 3)).astype(np.float32), init_scale=0.05, device="cpu")
    return g._replace(opacity_logit=torch.tensor(r.normal(0.0, 1.0, n), dtype=torch.float32))


def _batch(seed: int = 0):
    cams = orbit_cameras(BATCH, img_h=RES, img_w=RES)
    gt = torch.tensor(np.random.default_rng(seed).uniform(0, 1, (BATCH, RES, RES, 3)), dtype=torch.float32)
    return cams, gt


class _Feed:
    """The views object ``fit`` reads: the same batch every step."""

    def __init__(self, cams, gt):
        self.cams, self.gt = cams, gt

    def batches(self, batch_size, *, steps):
        for _ in range(steps):
            yield self.cams, self.gt


class _OneThread:
    """One torch thread, so that the CPU step is bitwise reproducible."""

    def __enter__(self):
        self._n = torch.get_num_threads()
        torch.set_num_threads(1)

    def __exit__(self, *exc):
        torch.set_num_threads(self._n)


def _trainer(trace: bool) -> GSTrainer:
    return GSTrainer(GSConfig(**CFG), params=_scene(512), device="cpu", obs=Obs(trace=trace), verbose=False)


def _check_tree(names, rids, steps, views, t0, t1, *, per_view, per_step, n_views):
    """Every stage span lies inside its step's ``dispatch`` span, under the
    fit call's rid, with ``step`` meta, and ``view`` on the per-view ones;
    each per-view stage once a view, each per-step stage once a step."""
    rid = {r for r, n in zip(rids, names) if n == "dispatch"}
    assert len(rid) == 1
    disp = {s: (a, b) for n, s, a, b in zip(names, steps, t0, t1) if n == "dispatch"}
    assert sorted(disp) == list(range(STEPS))
    count = Counter((n, s) for n, s in zip(names, steps) if n in STEP_STAGES)
    assert set(n for n, _ in count) == set(per_view) | set(per_step)
    for s in range(STEPS):
        for n in per_view:
            assert count[(n, s)] == n_views, (n, s)
        for n in per_step:
            assert count[(n, s)] == 1, (n, s)
    for n, r, s, v, a, b in zip(names, rids, steps, views, t0, t1):
        if n not in STEP_STAGES:
            continue
        assert r in rid and disp[s][0] <= a <= b <= disp[s][1], (n, s)
        assert (v >= 0) == (n in per_view), (n, v)
        if n in per_view:
            assert 0 <= v < n_views


def test_traced_fit_records_every_stage_inside_its_dispatch():
    cams, gt = _batch()
    with _OneThread():
        off, on = _trainer(False), _trainer(True)
        losses_off = off.fit(_Feed(cams, gt), steps=STEPS, densify=False)
        losses_on = on.fit(_Feed(cams, gt), steps=STEPS, densify=False)
    spans = on.obs.trace.drain()
    _check_tree([s.name for s in spans], [s.rid for s in spans], [s.meta.get("step", -1) for s in spans],
                [s.meta.get("view", -1) for s in spans], [s.t0 for s in spans], [s.t1 for s in spans],
                per_view=PER_VIEW, per_step=PER_STEP, n_views=BATCH)
    assert on.obs.trace.dropped == 0
    # the spans change nothing the step computes
    assert losses_off == losses_on
    for a, b in zip(off.state.params, on.state.params):
        assert torch.equal(a, b)


def test_backward_spans_join_their_step_from_another_thread():
    """The projection's and the compositor's Functions pin their step on
    the forward's thread; their backward, run on a thread with no step of
    its own (as the autograd engine's device threads are), records into
    that step with the forward's view."""
    rec = TraceRecorder()
    cams, gt = _batch()
    leaves = [x.detach().requires_grad_() for x in _scene(256)]
    with steptrace.in_step(rec, 41, 7) as tc:
        tc.view = 1
        packed = P.project(G.GaussianModel(*leaves), P.Camera(*[x[1] for x in cams]))
        pk, _ = P.sort_by_depth(packed)
        img, _ = R.render_packed(pk, img_h=RES, img_w=RES, k_per_tile=32)
        loss = (img - gt[1]).abs().mean()
    assert steptrace.current() is None
    seen = []

    def run():
        seen.append(steptrace.current())
        torch.autograd.grad(loss, leaves)

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert seen == [None]
    got = {(s.name, s.rid, s.meta["step"], s.meta["view"]) for s in rec.spans()}
    assert got == {("vjp", 41, 7, 1), ("raster_bwd", 41, 7, 1)}


def test_a_render_on_another_thread_stays_out_of_the_step():
    """While a traced step holds the slot on its thread, a render and its
    backward on another thread (a serving render sharing the ``Obs``)
    record nothing."""
    rec = TraceRecorder()
    cams, _ = _batch()
    g = _scene(256)
    leaves = [x.detach().requires_grad_() for x in g]
    done = threading.Event()

    def render():
        packed = P.project(G.GaussianModel(*leaves), P.Camera(*[x[0] for x in cams]))
        torch.autograd.grad(packed.sum(), leaves)
        done.set()

    with steptrace.in_step(rec, 5, 0):
        t = threading.Thread(target=render)
        t.start()
        t.join()
    assert done.is_set() and rec.spans() == []


@pytest.fixture(scope="module")
def mesh_spans(tmp_path_factory):
    """Traced ``fit`` on 2 gloo ranks: (1, 2) and (2, 1) projected, (1, 2)
    params3d."""
    g = _scene(512, seed=1)
    cams, gt = _batch(1)
    inputs = TR.flat_state(init_state(g), "a.state.")
    inputs.update({f"a.cams.{f}": np.asarray(x) for f, x in zip(cams._fields, cams)})
    inputs["a.gt"] = gt.numpy()
    tasks = [dict(kind="traced_fit", name=name, mesh=mesh, cfg=dict(CFG, gather_mode=mode), inputs="a.",
                  steps=STEPS) for name, mesh, mode in MESH_RUNS]
    return TR.spawn(tasks, 2, inputs, tmp_path_factory.mktemp("trace_ranks"))


MESH_RUNS = [("m1x2", [1, 2], "projected"), ("m2x1", [2, 1], "projected"), ("m1x2_p3d", [1, 2], "params3d")]


@pytest.mark.parametrize("name,mesh,mode", MESH_RUNS)
def test_mesh_step_records_gather_and_reduce(mesh_spans, name, mesh, mode):
    per_view, per_step = PER_VIEW + ("gather",), PER_STEP + ("reduce",)
    if mode == "params3d":  # the 3D state crosses the model axis once a step
        per_view, per_step = PER_VIEW, PER_STEP + MESH_ONLY
    for out in mesh_spans:
        f = {k: out[f"{name}/{k}"] for k in ("names", "rid", "step", "view", "t0", "t1")}
        _check_tree(*[list(f[k]) for k in ("names", "rid", "step", "view", "t0", "t1")],
                    per_view=per_view, per_step=per_step, n_views=BATCH // mesh[0])


def _under(e, name: str) -> bool:
    while e is not None:
        if e.name == name:
            return True
        e = e.cpu_parent
    return False


def test_profiled_step_names_its_stages_with_the_recorder_off():
    """With the recorder off (as the benchmark profiles), each stage opens
    its ``gs.<stage>`` range once a view or once a step, and the stage's
    aten ops lie under it."""
    cams, gt = _batch()
    with _OneThread():
        tr = _trainer(False)
        tr.fit(_Feed(cams, gt), steps=1, densify=False)  # warm
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            tr.fit(_Feed(cams, gt), steps=1, densify=False)
    events = list(prof.events())
    ranges = Counter(e.name for e in events if e.name.startswith("gs."))
    assert ranges == Counter({**{f"gs.{n}": BATCH for n in PER_VIEW}, **{f"gs.{n}": 1 for n in PER_STEP}})
    # plain ops, not user annotations: the profiler lays no copy of them on
    # the device's timeline, where they would read as busy time
    assert not any(e.is_user_annotation for e in events if e.name.startswith("gs."))
    for e in events:
        if e.name.startswith("gs."):
            kids, stack = [], list(e.cpu_children)
            while stack:
                c = stack.pop()
                kids.append(c.name)
                stack.extend(c.cpu_children)
            assert any(k.startswith("aten::") for k in kids), e.name
    for op, stage in (("aten::topk", "gs.bin"), ("aten::conv2d", "gs.loss")):
        found = [e for e in events if e.name == op]
        assert found and all(_under(e, stage) for e in found), op
    assert any(_under(e, "gs.sort") for e in events if e.name == "aten::sort")
    assert any(_under(e, "gs.adam") for e in events if e.name == "aten::sqrt")
    assert tr.obs.trace.spans() == []


def test_untraced_step_sites_allocate_nothing():
    """Tracing off and no profiler: the stage sites of a whole step, and
    ten thousand sites in a loop, allocate nothing in ``obs/steptrace.py``;
    an off site is one shared no-op context."""
    cams, gt = _batch()
    with _OneThread():
        tr = _trainer(False)
        tr.fit(_Feed(cams, gt), steps=1, densify=False)  # warm every path
        filt = [tracemalloc.Filter(True, "*obs/steptrace*")]
        tracemalloc.start()
        try:
            s1 = tracemalloc.take_snapshot()
            tr.fit(_Feed(cams, gt), steps=1, densify=False)
            for i in range(10_000):
                with steptrace.record(steptrace.current(), "bin", i & 7):
                    pass
                assert steptrace.pin() is steptrace.UNPINNED
            s2 = tracemalloc.take_snapshot()
        finally:
            tracemalloc.stop()
    diff = s2.filter_traces(filt).compare_to(s1.filter_traces(filt), "lineno")
    assert sum(abs(d.size_diff) for d in diff) == 0, diff
    assert steptrace.record(None, "bin", 0) is steptrace.record(None, "adam")


def test_chrome_export_lays_step_stages_after_the_overflow_lane():
    names = list(JSTAGES) + list(JTRAIN_STAGES) + ["mystery_stage"] + list(STEP_STAGES)
    spans = [(i, n, 1.0 + i, 1.5 + i) for i, n in enumerate(names)]
    ours = spans_to_chrome([Span(i, 1, n, a, b, {}) for i, n, a, b in spans])
    theirs = jax_spans_to_chrome([JSpan(i, 1, n, a, b, {}) for i, n, a, b in spans])
    tid = {e["name"]: e["tid"] for e in ours["traceEvents"] if e["ph"] == "X"}
    jtid = {e["name"]: e["tid"] for e in theirs["traceEvents"] if e["ph"] == "X"}
    overflow = (len(JSTAGES) + len(JTRAIN_STAGES) + 1) * LANE_STRIDE
    for n in list(JSTAGES) + list(JTRAIN_STAGES) + ["mystery_stage"]:
        assert tid[n] == jtid[n], n
    assert tid["mystery_stage"] == overflow == 320
    assert [tid[n] for n in STEP_STAGES] == [overflow + (i + 1) * LANE_STRIDE for i in range(len(STEP_STAGES))]
    labels = {e["tid"]: e["args"]["name"] for e in ours["traceEvents"] if e["ph"] == "M"}
    assert all(labels[tid[n]].endswith(f".{n}") for n in STEP_STAGES)


def test_loop_stages_are_the_jax_vocabulary():
    assert LOOP_STAGES == JTRAIN_STAGES
    assert set(STEP_STAGES) == set(PER_VIEW) | set(PER_STEP) | set(MESH_ONLY)
    assert set(steptrace.RANGES.values()) == {f"gs.{n}" for n in STEP_STAGES}
