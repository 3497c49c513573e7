"""``mir18m-sh3-train-512``'s comparison at a size a test run can hold: the
control (the reference with TF32 products in the program's place) fails the
cell's limits on three seeds, a sound run passes them, and each fault of a
one-chip cell (``gsbench/faults.py``) makes the run not correct."""
import time

import pytest

from gsbench.harness import gaps, reference_readings, run_rank
from gsbench.scene import FIELDS, batch_order, make_views

CELL = "mir18m-sh3-train-512"


def test_tf32_control_is_not_correct(tiny):
    cell = tiny(CELL)
    cfg, limits = cell["config_data"], cell["limits"]
    cams, gt = make_views(cfg, cell["traffic_data"], "cpu")
    for seed in (3_000_000_019, 3_001_000_022, 3_002_000_025):
        order = batch_order(cfg["views"], cell["traffic_data"]["batch"], seed)
        views = [next(order) for _ in range(3)]
        ref = reference_readings(cell, seed, cams, gt, views, "cpu")
        ctl = reference_readings(cell, seed, cams, gt, views, "cpu", tf32=True)
        ctl = dict(ctl, grad_norms=[ctl["grad_norms"][f] for f in FIELDS],
                   change_norms=[ctl["change_norms"][f] for f in FIELDS])
        got = gaps(ctl, ref, FIELDS)
        assert any(got[k] > limits[k] for k in limits), (seed, got)


@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch", "altered"])
def test_the_cell_catches_each_fault(tiny, fault):
    cell = tiny(CELL)
    r = run_rank(0, 1, dict(cell=cell, seed=3_000_000_019, seconds=0.3, trace=False, device="cpu", t0=time.time(),
                            cpu_threads=2, fault=fault))
    assert r["correct"] is (fault is None), r["compared"]
