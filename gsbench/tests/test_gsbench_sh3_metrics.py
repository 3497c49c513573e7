"""The readers of ``adam_sh_ms`` and ``gsproject_bwd_roofline``: on a
hand-made device trace each reads what was laid; on a trace without the
range or the kernel (the parent's program has no ``gs.adam_sh`` range)
each gives None; on a CPU profile of a tiny cell's step the ``gs.adam_sh``
range opens once a step inside ``gs.adam``; and the frozen bound equals the
port's ``kernels/cost.py`` formula."""
import time
import types

import pytest
from torch.profiler import ProfilerActivity, profile

from test_gsbench_ranges import _ev, _Prof

from gsbench.harness import Feed, build_trainer, metric_readers, setup
from gsbench.rangeread import ranges
from gsbench.scene import batch_order
from gsbench.work import least_ms

SEED = 3_300_000_023


def _hand_trace(with_sh_range=True, bwd_kernel="void gsproject_bwd_kernel<16>(float const*, int)"):
    """Two steps: a ``gs.adam`` range (6 us of kernels) holding a
    ``gs.adam_sh`` range (4 us), the forward kernel at 0.5 ms and the
    backward kernel at 1.0 and 1.2 ms."""
    ev = []
    for base in (0.0, 10_000.0):
        adam = _ev("gs.adam", base + 700, base + 790, device_ms=0.006)
        ev.append(adam)
        if with_sh_range:
            ev.append(_ev("gs.adam_sh", base + 750, base + 780, parent=adam, device_ms=0.004))
        ev.append(_ev("void gsproject_fwd_kernel<16>(float const*)", base + 1000, base + 1500, device=True))
    ev.append(_ev(bwd_kernel, 3000, 4000, device=True))
    ev.append(_ev(bwd_kernel, 13000, 14200, device=True))
    return _Prof(ev)


def test_adam_sh_ms_reads_the_nested_range():
    read = metric_readers()["adam_sh_ms"].read
    assert read(types.SimpleNamespace(prof=_hand_trace(), steps=2)) == pytest.approx(0.004)
    # the whole of Adam still reads the outer range, the SH field's share in it
    assert metric_readers()["adam_ms"].read(types.SimpleNamespace(prof=_hand_trace(), steps=2)) == pytest.approx(0.006)


def test_gsproject_bwd_roofline_reads_the_mean_backward_launch():
    mod = metric_readers()["gsproject_bwd_roofline"]
    n = 4_000_000
    ctx = types.SimpleNamespace(prof=_hand_trace(), steps=2, n_local=n, sh_coeffs=16)
    bound = least_ms(*mod.gsproject_bwd_cost(n, 16))
    assert bound == pytest.approx(2_064_000_000 / 3.35e12 * 1e3)
    assert mod.read(ctx) == pytest.approx(100.0 * bound / 1.1)


def test_a_program_without_the_range_or_the_kernel_reads_nothing():
    readers = metric_readers()
    ctx = types.SimpleNamespace(prof=_hand_trace(with_sh_range=False, bwd_kernel="some_other_kernel"), steps=2,
                                n_local=4_000_000, sh_coeffs=1)
    assert readers["adam_sh_ms"].read(ctx) is None
    assert readers["gsproject_bwd_roofline"].read(ctx) is None
    assert readers["gsproject_roofline"].read(ctx) is not None  # the forward kernel is there


@pytest.mark.parametrize("n", [4_000_000, 4_000_768, 18_180_096 // 4, 18_180_096])
@pytest.mark.parametrize("coeffs", [1, 4, 9, 16])
def test_the_frozen_backward_bound_equals_the_ports(n, coeffs):
    from repro_torch.kernels import cost

    mod = metric_readers()["gsproject_bwd_roofline"]
    assert mod.gsproject_bwd_cost(n, coeffs) == cost.gsproject_bwd_cost(n, coeffs)


def test_the_backward_bytes_at_4m_gaussians_at_degrees_0_and_3():
    mod = metric_readers()["gsproject_bwd_roofline"]
    assert mod.gsproject_bwd_cost(4_000_000, 1)[1] == 624_000_000
    assert mod.gsproject_bwd_cost(4_000_000, 16)[1] == 2_064_000_000


def test_the_adam_sh_range_opens_once_a_step_inside_adam_on_the_cpu(tiny):
    cell = tiny("mir18m-sh3-train-512")
    opts = dict(cell=cell, seed=SEED, device="cpu", t0=time.time(), cpu_threads=2)
    dev, mesh, _, cams, gt = setup(0, 1, opts)
    tr, _, _ = build_trainer(cell, SEED, dev, mesh, False)
    order = batch_order(cell["config_data"]["views"], cell["traffic_data"]["batch"], SEED)
    tr.fit(Feed(cams, gt, order, count=1), steps=1, densify=False, log_every=10**9)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.fit(Feed(cams, gt, order, count=2), steps=2, densify=False, log_every=10**9)
    sh, adam = ranges(prof, "gs.adam_sh"), ranges(prof, "gs.adam")
    assert len(sh) == len(adam) == 2
    for e in sh:
        parent = e.cpu_parent
        while parent is not None and parent.name != "gs.adam":
            parent = parent.cpu_parent
        assert parent is not None
