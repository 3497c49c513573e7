"""PyTorch port, in situ across ranks: ``InsituTrainer(mesh=...)`` on
spawned gloo ranks against the one-device trainer of the port, over the same
stream with the same seed and capacity.

Meshes (1, 2) (Gaussian shards and pixel strips) and (2, 1) (views), 2
timesteps: miranda at res 24, 32 px, K 128, batch 2, 600 points at capacity
1,024 (a cold start of 4 steps, then a warm one of 3 that reseeds). Every
rank gathers the full state to reseed it with the shared generator, so the
ranks must refill the same slots as one device, without sending any.
Tolerances: per-step losses rtol 1e-5 (float32 sums over the ranks in
another order, as ``tests/test_torch_train_ranks.py`` holds them); rank 0's
stored params atol 1e-5 of one device's store. The quaternions are held
through the covariance they shape, R diag(exp(2 log_scales)) R^T, at atol
1e-5 * max|covariance|, and on their own only to twice the distance Adam can
move them in the run's steps: a rotation of a Gaussian whose three scales are
equal changes no pixel, so at the isotropic init its quaternion's gradient is
a float32 cancellation whose sign the order of the strip sums decides, and
Adam (eps 1e-15) moves it by about its learning rate whatever that
gradient's size. On (1, 2) a few quaternion entries differ by 2e-5 while the
covariances agree to 1e-8.
"""
import numpy as np

import torch_port_helpers  # noqa: F401  (xdist workers share the host: a small torch pool)
import torch_ranks as TR
from repro_torch.core.config import GSConfig
from repro_torch.insitu import InsituTrainer, TemporalCheckpointStore
from repro_torch.volume.timevary import synthetic_stream

CFG = dict(img_h=32, img_w=32, batch_size=2, k_per_tile=128, max_steps=10, densify_from=10**9,
           opacity_reset_interval=10**9)
TRAINER = dict(capacity=1024, cold_steps=4, warm_steps=3, n_views=4, max_points=600, n_steps_raymarch=32,
               init_scale=0.06, seed=0)
STREAM = dict(dataset="miranda", n_timesteps=2, res=24, t1=0.15)
MESHES = ((1, 2), (2, 1))


def test_insitu_trainer_across_ranks_matches_one_device(tmp_path):
    runs = {}
    for m in MESHES:
        d = tmp_path / f"m{m[0]}x{m[1]}"
        task = dict(kind="insitu", name="insitu", mesh=list(m), cfg=CFG, trainer=TRAINER, stream=STREAM,
                    store=str(d / "seq"))
        runs[m] = (d, TR.start([task], 2, {"unused": np.zeros(1)}, d))

    cfg = GSConfig(**CFG)
    one = InsituTrainer(cfg, device="cpu", **TRAINER)
    with TemporalCheckpointStore(str(tmp_path / "one"), keyframe_interval=2) as store:
        reports = one.run(synthetic_stream(**STREAM), store=store)
        want = [store.load(t) for t in (0, 1)]
    assert reports[1].n_reseeded > 0 and one.n_traces == 1
    # Adam moves an entry by at most about lr * sqrt(batch) (the Grendel scaling) a step
    quat_bound = 2 * 1.01 * cfg.lr_quats * np.sqrt(cfg.batch_size) * len(one.step_losses)

    for m, (d, run) in runs.items():
        outs = TR.finish(run)
        for r, out in enumerate(outs):
            np.testing.assert_allclose(out["insitu/losses"], one.step_losses, rtol=1e-5, err_msg=f"{m} rank {r}")
            np.testing.assert_array_equal(out["insitu/reseed.0"], one.reseed_log[0], err_msg=f"{m} rank {r}")
            assert int(out["insitu/n_traces"]) == 1
            assert out["insitu/reports"][:, 0].tolist() == [r_.n_reseeded for r_ in reports]
            np.testing.assert_allclose(out["insitu/reports"][:, 2:], [[r_.psnr_before, r_.psnr_after] for r_ in reports],
                                       atol=1e-3)
        got = TemporalCheckpointStore(str(d / "seq"))
        assert got.timesteps() == [0, 1]
        for t in (0, 1):
            g = got.load(t)
            for f in want[t]._fields:
                a, b = np.asarray(getattr(g, f)), np.asarray(getattr(want[t], f))
                if f == "quats":
                    assert np.abs(a - b).max() <= quat_bound, (m, t)
                else:
                    np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=f"{m} t={t} {f}")
            cov_a, cov_b = _covariance(g), _covariance(want[t])
            np.testing.assert_allclose(cov_a, cov_b, atol=1e-5 * np.abs(cov_b).max(), rtol=0,
                                       err_msg=f"{m} t={t} covariance")


def _covariance(g) -> np.ndarray:
    """(N, 3, 3) covariances R diag(exp(2 log_scales)) R^T, in float64."""
    q = np.asarray(g.quats, np.float64)
    w, x, y, z = (q / np.linalg.norm(q, axis=1, keepdims=True)).T
    rot = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                    2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                    2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], 1).reshape(-1, 3, 3)
    return np.einsum("nij,nj,nkj->nik", rot, np.exp(2 * np.asarray(g.log_scales, np.float64)), rot)


def test_insitu_cli_across_two_ranks_keeps_one_store_on_rank_0(tmp_path):
    """``torch.distributed.run --nproc-per-node 2 -m repro_torch.launch.insitu
    --smoke --device cpu --model-par 2``: every rank trains its shard, rank 0
    alone keeps the temporal store, serves the scrub smoke and prints; the
    sequence it wrote reads back through the JAX package's store."""
    import json
    import os
    import subprocess
    import sys

    from repro.insitu import TemporalCheckpointStore as JStore

    seq, report = tmp_path / "seq", tmp_path / "report.json"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
           "-m", "repro_torch.launch.insitu", "--smoke", "--device", "cpu", "--model-par", "2", "--res", "32",
           "--timesteps", "2", "--cold-steps", "4", "--warm-steps", "3", "--ckpt", str(seq),
           "--report", str(report)]
    r = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=TR.RANK_TIMEOUT_S,
                       env=dict(os.environ, PYTHONPATH=str(TR.REPO / "src"), OMP_NUM_THREADS="1"))
    assert r.returncode == 0, (r.stdout + r.stderr)[-4000:]
    assert r.stdout.count("insitu ok") == 1  # only rank 0 prints
    out = json.loads(report.read_text())
    assert out["config"]["mesh"] == {"data": 1, "model": 2} and out["recompile_count"] == 1
    assert out["shard_balance"]["n_shards"] == 2 and out["scrub"]["replay_new_misses"] == 0
    assert JStore(str(seq)).timesteps() == [0, 1]
