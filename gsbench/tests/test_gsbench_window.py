"""The window repeats the same steps whatever the program's speed: each
stretch starts from the set-up's snapshot and the seed's first batches, so
its losses repeat stretch after stretch, and a restore brings back every
tensor of the train state."""
import time

import torch

from gsbench.harness import Feed, Snapshot, _state_tensors, build_trainer, program_readings, run_window, setup
from gsbench.scene import batch_order

SEED = 2_900_000_033


def _trainer(tiny):
    cell = tiny("ks4m-train-512")
    opts = dict(cell=cell, seed=SEED, device="cpu", t0=time.time(), cpu_threads=2)
    dev, mesh, _, cams, gt = setup(0, 1, opts)
    tr, _, _ = build_trainer(cell, SEED, dev, mesh, False)
    views, batch = cell["config_data"]["views"], cell["traffic_data"]["batch"]

    def new_order():
        return batch_order(views, batch, SEED)

    program_readings(tr, cams, gt, new_order(), mesh)
    return tr, cams, gt, new_order, views // batch


def test_a_restore_brings_back_the_whole_state(tiny):
    tr, cams, gt, new_order, _ = _trainer(tiny)
    before = [t.clone() for t in _state_tensors(tr.state)]
    snap = Snapshot(tr)
    # a stretch longer than the window: the window ends inside its first
    # stretch, after one step or more and before any restore of its own,
    # wherever the clock stops it
    win = run_window(tr, snap, cams, gt, new_order, 0.5, 10**6)
    assert 0 < win["steps"] < 10**6
    assert any(not torch.equal(a, b) for a, b in zip(before, _state_tensors(tr.state)))
    snap.restore(tr)
    after = _state_tensors(tr.state)
    assert len(after) == len(before)
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_every_stretch_of_the_window_repeats_the_first(tiny):
    tr, cams, gt, new_order, stretch = _trainer(tiny)
    t0 = time.perf_counter()
    tr.fit(Feed(cams, gt, new_order(), count=stretch), steps=stretch, densify=False, log_every=10**9)
    one = time.perf_counter() - t0
    snap = Snapshot(tr)  # a state past set-up: the window starts from whatever state it is handed
    win = run_window(tr, snap, cams, gt, new_order, 2.6 * one + 0.5, stretch)
    assert win["steps"] >= 2 * stretch and len(win["losses"]) == win["steps"] == len(win["step_ms"])
    assert 0.0 < win["window_s"]
    first = win["losses"][:stretch]
    for i in range(stretch, win["steps"], stretch):
        part = win["losses"][i:i + stretch]
        assert part == first[:len(part)]

