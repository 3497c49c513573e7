"""The readers of the program's stage spans and ranges (``vjp_dispatch_ms``,
``bin_ms``, ``adam_ms``, ``vjp_idle_ms``, ``loss_ms``;
``gsbench/rangeread.py``): on a CPU profile of a tiny cell's step, ranges
are found by their whole name; on a hand-made device trace the device
times and the idle split come out as laid, the idle by range and outside
every range summing to the whole idle; on a trace and spans without the
program's stages every reader gives None."""
import time
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gsbench.harness import Feed, build_trainer, metric_readers, setup
from gsbench.rangeread import idle_by_range, idle_gaps, range_device_ms, ranges
from gsbench.scene import batch_order

SEED = 3_000_000_019
NEW = ("vjp_dispatch_ms", "bin_ms", "adam_ms", "vjp_idle_ms")
_CUDA = torch.autograd.DeviceType.CUDA
_CPU = torch.autograd.DeviceType.CPU


@pytest.fixture(scope="module")
def cpu_profile():
    """A tiny one-card cell on the CPU: two traced steps through ``fit``
    (its spans), then one step under the profiler with the recorder off, as
    the harness's traced run does."""
    from gsbench.tests.conftest import shrink
    from gsbench.harness import load_cell

    cell = shrink(load_cell("ks4m-train-512"))
    opts = dict(cell=cell, seed=SEED, device="cpu", t0=time.time(), cpu_threads=2)
    dev, mesh, _, cams, gt = setup(0, 1, opts)
    tr, _, _ = build_trainer(cell, SEED, dev, mesh, True)
    order = batch_order(cell["config_data"]["views"], cell["traffic_data"]["batch"], SEED)
    tr.fit(Feed(cams, gt, order, count=2), steps=2, densify=False, log_every=10**9)
    spans = [(s.name, s.t0, s.t1) for s in tr.obs.trace.drain()]
    tr.obs.disable_trace()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.fit(Feed(cams, gt, order, count=1), steps=1, densify=False, log_every=10**9)
    return prof, spans


def test_ranges_are_found_by_their_whole_name(cpu_profile):
    prof, _ = cpu_profile
    raster, raster_bwd = ranges(prof, "gs.raster"), ranges(prof, "gs.raster_bwd")
    assert len(raster) == len(raster_bwd) == 2  # one a view, batch 2
    assert all(e.name == "gs.raster" for e in raster)
    for name in ("gs.project", "gs.sort", "gs.bin", "gs.vjp"):
        assert len(ranges(prof, name)) == 2, name
    for name in ("gs.loss", "gs.backward", "gs.adam"):
        assert len(ranges(prof, name)) == 1, name
    assert ranges(prof, "gs.gather") == []  # one card: nothing is gathered


def test_vjp_dispatch_ms_reads_the_trainers_spans(cpu_profile):
    _, spans = cpu_profile
    read = metric_readers()["vjp_dispatch_ms"].read
    got = read(types.SimpleNamespace(spans=spans))
    vjp = [b - a for n, a, b in spans if n == "vjp"]
    assert len(vjp) == 4 and sum(n == "dispatch" for n, _, _ in spans) == 2
    assert got == pytest.approx(1e3 * sum(vjp) / 2) and got > 0
    hand = [("dispatch", 0.0, 1.0), ("vjp", 0.1, 0.3), ("vjp", 0.4, 0.45), ("dispatch", 1.0, 2.0),
            ("vjp", 1.1, 1.2), ("batch", 2.0, 2.5)]
    assert read(types.SimpleNamespace(spans=hand)) == pytest.approx(1e3 * 0.35 / 2)


def _ev(name, start, end, *, device=False, parent=None, device_ms=0.0):
    e = types.SimpleNamespace(name=name, device_type=_CUDA if device else _CPU,
                              time_range=types.SimpleNamespace(start=start, end=end), cpu_parent=parent,
                              device_time_total=device_ms * 1e3)
    return e


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _hand_trace():
    """Two steps of host ranges (us) and the kernels they launched: gs.bin
    and gs.adam with their device time, gs.vjp on the autograd thread inside
    gs.backward, and device intervals whose gaps begin in gs.bin (5 us), in
    gs.vjp (20 + 30 us), in gs.backward outside gs.vjp (7 us) and outside
    every range (11 us)."""
    host = []
    for base in (0.0, 1000.0):
        b = _ev("gs.bin", base + 0, base + 100, device_ms=0.004)
        host += [b, _ev("aten::topk", base + 10, base + 20, parent=b, device_ms=0.004)]
        bw = _ev("gs.backward", base + 200, base + 600)
        host += [bw, _ev("gs.vjp", base + 250, base + 400), _ev("gs.raster_bwd", base + 440, base + 500)]
        host += [_ev("gs.adam", base + 700, base + 790, device_ms=0.006)]
        host += [_ev("gs.raster", base + 900, base + 950)]
    dev = [_ev("k", 10, 50, device=True), _ev("k", 55, 260, device=True), _ev("k", 280, 300, device=True),
           _ev("k", 330, 430, device=True), _ev("k", 437, 800, device=True), _ev("k", 811, 1200, device=True)]
    return _Prof(host + dev)


def test_device_times_and_the_idle_split_on_a_hand_made_trace():
    prof = _hand_trace()
    readers = metric_readers()
    ctx = types.SimpleNamespace(prof=prof, steps=2)
    assert readers["bin_ms"].read(ctx) == pytest.approx(0.004)
    assert readers["adam_ms"].read(ctx) == pytest.approx(0.006)
    assert range_device_ms(prof, "gs.raster") == 0.0 and range_device_ms(prof, "gs.gather") is None
    split = idle_by_range(prof)
    total = sum(length for _, length in idle_gaps(prof)) / 1e3
    assert split == pytest.approx({"gs.bin": 0.005, "gs.vjp": 0.050, "gs.backward": 0.007, None: 0.011})
    assert sum(split.values()) == pytest.approx(total) == pytest.approx(0.073)
    assert readers["vjp_idle_ms"].read(ctx) == pytest.approx(0.050 / 2)


def test_the_idle_split_sums_to_the_whole_idle_on_a_cpu_step(cpu_profile):
    prof, _ = cpu_profile
    split = idle_by_range(prof)  # no device rows on the CPU: no gaps
    assert sum(split.values()) == sum(length for _, length in idle_gaps(prof)) / 1e3 == 0.0


def test_a_program_without_the_stages_reads_nothing():
    """The parent's program: no ``gs.*`` range and no ``vjp`` span. Each new
    reader gives None, so the metric is left out of the line."""
    prof = _Prof([_ev("ProjectBackward", 0, 100, device_ms=1.0), _ev("k", 0, 50, device=True),
                  _ev("k", 60, 90, device=True)])
    ctx = types.SimpleNamespace(prof=prof, steps=5, spans=[("batch", 0.0, 1.0), ("dispatch", 1.0, 2.0)])
    readers = metric_readers()
    assert {name: readers[name].read(ctx) for name in NEW} == dict.fromkeys(NEW)


def test_loss_ms_reads_the_loss_range_and_the_windows_transpose():
    """Two steps: each a ``gs.loss`` range (3 us of kernels) and the
    autograd node of the SSIM window's transpose, its evaluate_function
    event holding the ``ConvolutionBackward0`` op (2 us, counted once)."""
    ev = []
    for base in (0.0, 1000.0):
        ev.append(_ev("gs.loss", base + 0, base + 100, device_ms=0.003))
        node = _ev("autograd::engine::evaluate_function: ConvolutionBackward0", base + 200, base + 300,
                   device_ms=0.002)
        ev += [node, _ev("ConvolutionBackward0", base + 210, base + 290, parent=node, device_ms=0.002)]
        ev.append(_ev("autograd::engine::evaluate_function: MulBackward0", base + 300, base + 320, device_ms=0.004))
    read = metric_readers()["loss_ms"].read
    assert read(types.SimpleNamespace(prof=_Prof(ev), steps=2)) == pytest.approx(0.005)
    only_fwd = [e for e in ev if "Convolution" not in e.name]
    assert read(types.SimpleNamespace(prof=_Prof(only_fwd), steps=2)) == pytest.approx(0.003)
    neither = [e for e in only_fwd if e.name != "gs.loss"]
    assert read(types.SimpleNamespace(prof=_Prof(neither), steps=2)) is None


def test_loss_ms_finds_its_range_and_node_in_a_cpu_step(cpu_profile):
    """The CPU step has the ``gs.loss`` range and the window's transpose node
    once each (the SSIM's one grouped convolution a step) but no device
    time: the reader gives None there."""
    prof, _ = cpu_profile
    assert len(ranges(prof, "gs.loss")) == 1
    nodes = [e for e in prof.events() if e.name == "autograd::engine::evaluate_function: ConvolutionBackward0"]
    assert len(nodes) == 1
    assert metric_readers()["loss_ms"].read(types.SimpleNamespace(prof=prof, steps=1)) is None
