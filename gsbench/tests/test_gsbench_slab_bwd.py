"""``slab_bwd_ms``, the device time under the train step's ``gs.slab_bwd``
ranges: on a hand-made trace it reads the range's device time a step; on a
CPU profile of a tiny cell's step the range opens once a view, around the
plain transpose; a program without the range reads None."""
import time
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gsbench.harness import Feed, build_trainer, metric_readers, setup
from gsbench.rangeread import ranges
from gsbench.scene import batch_order

SEED = 3_000_000_023
_CUDA = torch.autograd.DeviceType.CUDA
_CPU = torch.autograd.DeviceType.CPU


def _ev(name, start, end, *, device=False, device_ms=0.0):
    return types.SimpleNamespace(name=name, device_type=_CUDA if device else _CPU,
                                 time_range=types.SimpleNamespace(start=start, end=end), cpu_parent=None,
                                 device_time_total=device_ms * 1e3)


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_slab_bwd_ms_reads_the_range_a_step():
    host = []
    for base in (0.0, 1000.0):
        host += [_ev("gs.raster_bwd", base + 440, base + 500, device_ms=0.002),
                 _ev("gs.slab_bwd", base + 510, base + 540, device_ms=0.003),
                 _ev("gs.slab_bwd", base + 560, base + 590, device_ms=0.001)]
    ctx = types.SimpleNamespace(prof=_Prof(host + [_ev("k", 0, 50, device=True)]), steps=2)
    assert metric_readers()["slab_bwd_ms"].read(ctx) == pytest.approx(0.004)


def test_a_program_without_the_range_reads_nothing():
    prof = _Prof([_ev("IndexBackward0", 0, 100, device_ms=1.0), _ev("k", 0, 50, device=True)])
    assert metric_readers()["slab_bwd_ms"].read(types.SimpleNamespace(prof=prof, steps=5)) is None


def test_the_range_opens_once_a_view_on_a_cpu_step(tiny):
    cell = tiny("ks4m-train-512")
    opts = dict(cell=cell, seed=SEED, device="cpu", t0=time.time(), cpu_threads=2)
    dev, mesh, _, cams, gt = setup(0, 1, opts)
    tr, _, _ = build_trainer(cell, SEED, dev, mesh, False)
    order = batch_order(cell["config_data"]["views"], cell["traffic_data"]["batch"], SEED)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.fit(Feed(cams, gt, order, count=1), steps=1, densify=False, log_every=10**9)
    assert len(ranges(prof, "gs.slab_bwd")) == 2  # one a view, batch 2
    assert ranges(prof, "gs.slab_bwd")[0].name == "gs.slab_bwd"
    # the CPU's plain transpose (autograd of the gathers) runs inside the range, and no other
    index_bwd = [e for e in prof.events() if e.name == "IndexBackward0"]
    assert len(index_bwd) == 4 and all(_inside(e, "gs.slab_bwd") for e in index_bwd)


def _inside(e, name: str) -> bool:
    while e is not None and e.name != name:
        e = e.cpu_parent
    return e is not None
