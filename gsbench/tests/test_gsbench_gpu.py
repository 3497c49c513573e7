"""On the card: the one-chip cell's comparison at its own size, one seed,
the program against the reference within the cell's limits and the TF32
control outside them. Skips without a CUDA device (decided in the test).

  python -m pytest -m gpu gsbench/tests/test_gsbench_gpu.py
"""
import pytest
import torch


@pytest.mark.gpu
def test_one_chip_cell_at_its_size_against_the_reference_and_the_control():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import time

    from gsbench.harness import (build_trainer, gaps, load_cell, program_readings, reference_readings, setup)
    from gsbench.scene import FIELDS, batch_order

    cell = load_cell("ks4m-train-512")
    opts = dict(cell=cell, device="cuda", t0=time.time())
    dev, mesh, cams, prog_cams, gt = setup(0, 1, opts)
    seed = 6_000_000_001
    tr, _, _ = build_trainer(cell, seed, dev, mesh, False)
    prog = program_readings(tr, prog_cams, gt, batch_order(cell["config_data"]["views"], 4, seed), mesh)
    del tr
    torch.cuda.empty_cache()
    ref = reference_readings(cell, seed, cams, gt, prog["views"], dev)
    got = gaps(prog, ref, FIELDS)
    assert all(got[k] <= v for k, v in cell["limits"].items()), got
    ctl = reference_readings(cell, seed, cams, gt, prog["views"], dev, tf32=True)
    ctl = dict(ctl, grad_norms=[ctl["grad_norms"][f] for f in FIELDS],
               change_norms=[ctl["change_norms"][f] for f in FIELDS])
    got = gaps(ctl, ref, FIELDS)
    assert any(got[k] > v for k, v in cell["limits"].items()), got
