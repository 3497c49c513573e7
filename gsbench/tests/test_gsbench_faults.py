"""A run with the timed path broken underneath comes out not correct: once
for each fault a cell can have (``gsbench/faults.py``), with the look for
a chip skipped and everything else of a run driven on the CPU, the
four-chip cell on four gloo ranks."""
import json
import os
import tempfile
import time

import pytest

from gsbench.harness import run_rank

FAULTS_ONE = ["unchanged", "half_batch", "altered"]
FAULTS_MESH = ["unchanged", "half_batch", "altered", "no_exchange"]


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
def test_one_chip_cell_catches_each_fault(tiny, fault):
    cell = tiny("ks4m-train-512")
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
