"""PyTorch port, ``benchmarks/gs_dryrun_torch.py`` on the CPU: the GS train
step counted under ``launch/op_cost.py`` ``OpCost`` on one rank and on two
gloo ranks, one JSON per point, and ``benchmarks/roofline_torch.py``'s
table of them."""
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _run(args, cwd):
    r = subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1"))
    assert r.returncode == 0, (r.stdout[-1500:], r.stderr[-2500:])
    return r.stdout


def test_gs_dryrun_mirror_counts_a_step_on_gloo_ranks(tmp_path):
    """``benchmarks/gs_dryrun_torch.py`` on the CPU: one rank, then two gloo
    ranks on the model axis, each point's count written as JSON; the two
    ranks' step moves its all-gather and reduce-scatter bytes."""
    out = tmp_path / "gsd"
    stdout = _run([str(REPO / "benchmarks" / "gs_dryrun_torch.py"), "--points", "3000", "--res", "32", "--workers",
                   "1", "2", "--device", "cpu", "--volume-res", "32", "--warmup", "1", "--steps", "1", "--out",
                   str(out), "--scratch", str(tmp_path / "scratch")], tmp_path)
    assert "world 2: 1 points" in stdout
    one = json.loads((out / "gs_3000_32_1w.json").read_text())
    two = json.loads((out / "gs_3000_32_2w.json").read_text())
    for rec in (one, two):
        assert {"flops", "hbm_bytes", "collective_bytes", "collectives", "peak_bytes"} <= set(rec["per_worker"])
        assert set(rec["roofline_s"]) == {"compute", "memory", "collective"}
        assert rec["measured_step_ms"] is None and rec["roofline_share"] is None  # no card: not measured
        assert rec["by_op"]["gsproject"]["count"] == 4 and rec["by_op"]["tile_raster_bwd"]["count"] == 4
    assert one["per_worker"]["collective_bytes"] == 0 and two["per_worker"]["collective_bytes"] > 0
    assert two["per_worker"]["collectives"]["all-gather"]["count"] > 0
    assert two["per_worker"]["collectives"]["reduce-scatter"]["count"] > 0

    sys.path.insert(0, str(REPO / "benchmarks"))
    import roofline_torch

    rows = []
    roofline_torch.gs_table([str(out)], rows.append)
    assert len(rows) == 3 and rows[2].startswith("| gs 3000 | 32 | ")
    assert " | n/a / n/a / n/a | " in rows[2]  # no card: no measured step, no share
    assert f"{one['per_worker']['peak_bytes']} |" in rows[2]
