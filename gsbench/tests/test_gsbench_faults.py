"""A run with the timed path broken underneath comes out not correct: once
for each fault a cell can have (``gsbench/faults.py``), with the look for
a chip skipped and everything else of a run driven on the CPU, in each
one-chip cell, and the four-chip cell on four gloo ranks."""
import json
import os
import tempfile
import time

import pytest

from conftest import BLOCKED

from gsbench.harness import run_rank
from gsbench.reference import step as RS

FAULTS_ONE = ["unchanged", "half_batch", "altered"]
FAULTS_MESH = ["unchanged", "half_batch", "altered", "no_exchange"]
ONE_CHIP = ["ks4m-train-512", "mir18m-sh3-train-512", "ks4m-train-2048"]


def _run_mesh(cell, fault):
    from repro_torch.launch.mesh import spawn_ranks

    from gsbench.run import _rank

    with tempfile.TemporaryDirectory() as tmp:
        opts = dict(cell=cell, seed=4_100_000_007, seconds=0.5, trace=False, device="cpu", t0=time.time(),
                    rendezvous=os.path.join(tmp, "rendezvous"), result_path=os.path.join(tmp, "result.json"),
                    fault=fault)
        spawn_ranks(_rank, (cell["chips"], opts), cell["chips"], timeout_s=600)
        with open(opts["result_path"]) as f:
            return json.load(f)


@pytest.mark.parametrize("fault", [None] + FAULTS_ONE)
@pytest.mark.parametrize("name", ONE_CHIP)
def test_one_chip_cell_catches_each_fault(tiny, monkeypatch, name, fault):
    monkeypatch.setattr(RS, "BLOCK_TILES", BLOCKED)
    cell = tiny(name)
    r = run_rank(0, 1, dict(cell=cell, seed=3_000_000_019, seconds=0.3, trace=False, device="cpu", t0=time.time(),
                            cpu_threads=2, fault=fault))
    assert r["correct"] is (fault is None), r["compared"]


@pytest.mark.parametrize("fault", [None] + FAULTS_MESH)
def test_four_chip_cell_catches_each_fault(tiny, fault):
    # flat lists: at 64 px a strip's superblocks are not the frame's
    cell = tiny("mir18m-train-512-x4", binning="flat")
    r = _run_mesh(cell, fault)
    assert r["device"]["count"] == 4
    assert r["correct"] is (fault is None), r["compared"]
