"""The control, the reference computed with TF32 products in the
program's place, fails the cell's limits on at least one number, at a
size a test run can hold, on three seeds, in every cell."""
import pytest

from conftest import BLOCKED

from gsbench.harness import gaps, reference_readings
from gsbench.reference import step as RS
from gsbench.scene import FIELDS, batch_order, make_views

CELLS = ["ks4m-train-512", "mir18m-train-512-x4", "mir18m-sh3-train-512", "ks4m-train-2048"]


@pytest.mark.parametrize("name", CELLS)
def test_tf32_control_is_not_correct(tiny, monkeypatch, name):
    monkeypatch.setattr(RS, "BLOCK_TILES", BLOCKED)
    cell = tiny(name)
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
