"""End-to-end distributed 3D-GS training (PyTorch port): trainer and CLI.

  volume -> isosurface points -> Gaussian init -> GT orbit renders ->
  Grendel-style optimization over a (data, model) mesh of ranks
  (+ densification rounds) -> metrics (PSNR / SSIM / LPIPS-proxy) +
  checkpoints.

Runs on the card by default and raises when there is none; ``--device cpu``
trains through the plain PyTorch versions instead. With ``--data-par`` or
``--model-par`` above 1 it runs one process per rank under torchrun: each
rank takes ``cuda:LOCAL_RANK`` and NCCL (or the CPU and gloo with
``--device cpu``), and only rank 0 prints and writes files (the per-step
span trace of ``--trace-out`` too: JSONL in the JAX package's schema, with
a Perfetto-viewable ``.chrome.json`` beside it).

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --dataset kingsnake \
      --volume-res 32 --max-points 800 --res 32 --steps 8 --views 4 --batch 2 --ckpt experiments/ckpts/tckpt
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 2 -m repro_torch.launch.train \
      --device cpu --model-par 2 --volume-res 32 --max-points 800 --res 32 --steps 8 --views 4 --batch 2
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs.gs_datasets import DATASETS
from repro_torch.core import gaussians as G
from repro_torch.core.config import GSConfig
from repro_torch.core.densify import DEAD_LOGIT, densify_and_rebalance, reset_opacity
from repro_torch.core.losses import lpips_proxy, psnr, ssim
from repro_torch.core.sharding import Mesh
from repro_torch.core.train import (
    all_gather_bytes_per_step,
    init_state,
    make_eval_render,
    make_train_step,
    record_shard_balance,
    shard_balance,
    shard_state,
)
from repro_torch.data.views import ViewDataset
from repro_torch.launch.mesh import init_ranks, make_gs_mesh
from repro_torch.obs import Obs, devmem, export_trace, new_request_id, steptrace
from repro_torch.obs.clock import now, since
from repro_torch.volume import datasets as VD
from repro_torch.volume.isosurface import extract_isosurface_points


class GSTrainer:
    """Owns the train state (this rank's shard of it on a mesh) and the
    train step."""

    def __init__(self, cfg: GSConfig, points=None, colors=None, *, device="cuda", verbose: bool = True,
                 obs: Obs | None = None, params: G.GaussianModel | None = None, mesh: Mesh | None = None):
        """Seed the model from isosurface ``points`` and ``colors`` (padded
        with dead Gaussians to the shard quantum), or start from ``params``
        (a full host or device model, e.g. a checkpoint's) as given. On a
        ``mesh`` every rank passes the same full model and keeps its shard,
        on the mesh's device."""
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("GSTrainer: no CUDA device; pass device='cpu' to train on the CPU")
        self.n_shards = mesh.model.size if mesh is not None else 1
        self.verbose = verbose
        # training telemetry bundle: share one with a serving stack and
        # train spans/metrics land next to request spans on one clock
        self.obs = obs if obs is not None else Obs()
        if params is not None:
            g = G.GaussianModel(*params).to(self.device)
        else:
            n0 = points.shape[0]
            pad = (-n0) % (self.n_shards * cfg.pad_quantum)
            pts = np.concatenate([np.asarray(points, np.float32), np.full((pad, 3), 1e6, np.float32)])
            cols = np.concatenate([np.asarray(colors, np.float32), np.zeros((pad, 3), np.float32)])
            g = G.init_from_points(pts, cols, sh_degree=cfg.sh_degree, device=self.device)
            g.opacity_logit[n0:] = DEAD_LOGIT
        self.state = init_state(g) if mesh is None else shard_state(init_state(g), mesh)
        self.step_fn = make_train_step(cfg, mesh)
        self.step_ms_log: list[float] = []  # wall ms of each step of the last fit, device included
        self.densify_reports: list = []     # DensifyReport of each densify round, in order

    def shard_balance(self, *, record: bool = True) -> dict:
        """Per-shard load stats (``train.shard_*`` gauges when ``record``)."""
        bal = shard_balance(self.state, self.mesh, opacity_thresh=self.cfg.prune_opacity_thresh)
        if record:
            record_shard_balance(self.obs.metrics, bal)
        return bal

    def fit(self, data: ViewDataset, *, steps: int, densify: bool = True, log_every: int = 50,
            scene_extent: float = 1.0):
        """Per-step telemetry rides the registry (``train.loss`` gauge,
        ``train.step_ms`` histogram, ``train.gather_bytes``); spans cover
        batch assembly -> dispatch -> device compute (bounded by a device
        synchronize, traced runs only) -> densify rounds, and inside each
        ``dispatch`` the step's own stages (``obs/steptrace.py``)."""
        m = self.obs.metrics
        loss_gauge = m.gauge("train.loss")
        step_ms = m.histogram("train.step_ms")
        device_ms = m.histogram("train.device_ms")
        gather_bytes = m.counter("train.gather_bytes")
        steps_total = m.counter("train.steps")
        rid = new_request_id()  # one span tree per fit call
        gb = all_gather_bytes_per_step(self.cfg, self.mesh, self.state.params.n * self.n_shards)
        losses = []
        self.step_ms_log = []
        t0 = now()
        t_iter = t0
        for i, (cams, gt) in enumerate(data.batches(self.cfg.batch_size, steps=steps)):
            rec = self.obs.trace
            t_batch = now()
            if rec:
                rec.record(rid, "batch", t_iter, t_batch, step=i)
            with steptrace.in_step(rec, rid, i):  # the step's stage spans (core/train.py)
                self.state, metrics = self.step_fn(self.state, cams, gt)
            if rec:
                t_disp = now()
                rec.record(rid, "dispatch", t_batch, t_disp, step=i)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                t_dev = now()
                rec.record(rid, "device", t_disp, t_dev, step=i)
                device_ms.observe((t_dev - t_disp) * 1e3)
            losses.append(float(metrics["loss"]))  # waits for the step
            loss_gauge.set(losses[-1])
            steps_total.inc()
            gather_bytes.inc(gb)
            self.step_ms_log.append(since(t_batch) * 1e3)
            step_ms.observe(self.step_ms_log[-1])
            step = int(self.state.step)
            if densify and self.cfg.densify_from <= step <= self.cfg.densify_until and step % self.cfg.densify_interval == 0:
                t_d = now()
                self.state, report = densify_and_rebalance(
                    self.state, self.cfg, n_shards=self.n_shards, scene_extent=scene_extent, mesh=self.mesh
                )
                gb = all_gather_bytes_per_step(self.cfg, self.mesh, self.state.params.n * self.n_shards)
                self.densify_reports.append(report)
                rec = self.obs.trace
                if rec:
                    rec.record(rid, "densify", t_d, now(), step=step, n=int(self.state.params.n))
                self.shard_balance()  # densify is where shards skew
                if self.verbose:
                    print(f"  densify @ {step}: {report}")
            if densify and step % self.cfg.opacity_reset_interval == 0 and step > 0:
                self.state = reset_opacity(self.state)
            if self.verbose and i % log_every == 0:
                snap = m.snapshot()  # ONE atomic read: loss + timing agree
                print(
                    f"step {step:6d} loss {snap['train.loss']:.5f} "
                    f"step_ms p50 {snap['train.step_ms']['p50']:.1f} "
                    f"({since(t0):.1f}s)"
                )
            t_iter = now()
        self.shard_balance()
        devmem.record(m)
        return losses

    @torch.no_grad()
    def evaluate(self, data: ViewDataset, view_ids) -> dict:
        eval_fn = make_eval_render(self.cfg, self.mesh)
        rec = self.obs.trace
        rid = new_request_id()
        t0 = now() if rec else 0.0
        ps, ss, lp = [], [], []
        for i in view_ids:
            cam, gt = data.view(int(i))
            img, _ = eval_fn(self.state.params, cam)
            ps.append(float(psnr(img, gt)))
            ss.append(float(ssim(img, gt)))
            lp.append(float(lpips_proxy(img, gt)))
        out = {"psnr": float(np.mean(ps)), "ssim": float(np.mean(ss)), "lpips_proxy": float(np.mean(lp))}
        self.obs.metrics.gauge("train.psnr").set(round(out["psnr"], 4))
        if rec:
            rec.record(rid, "eval", t0, now(), views=len(ps), psnr=round(out["psnr"], 3))
        return out


def build_dataset(name: str, *, volume_res: int, n_views: int, img_h: int, img_w: int,
                  max_points: int | None, cache_dir: str | None = "experiments/gt_cache", device="cuda"):
    """Volume, isosurface points and colors, and the GT views (rendered on
    ``device``, by default the card; cached under the JAX package's file
    names)."""
    ds = DATASETS[name]
    vol = getattr(VD, ds.volume)(res=volume_res)
    pts, _, cols = extract_isosurface_points(vol, max_points=max_points)
    data = ViewDataset(vol, n_views=n_views, img_h=img_h, img_w=img_w, radius=ds.radius,
                       cache_dir=cache_dir, device=device)
    return vol, pts, cols, data


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="torch device to train on (default: the card; cuda:LOCAL_RANK "
                                                       "across ranks)")
    ap.add_argument("--dataset", choices=list(DATASETS), default="kingsnake")
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--volume-res", type=int, default=48)
    ap.add_argument("--views", type=int, default=24)
    ap.add_argument("--max-points", type=int, default=4000)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--data-par", type=int, default=1, help="data-axis ranks (views); above 1: run under torchrun")
    ap.add_argument("--model-par", type=int, default=1, help="model-axis ranks (Gaussian shards, pixel strips)")
    ap.add_argument("--k-per-tile", type=int, default=256)
    ap.add_argument("--gather-mode", default="auto", choices=["auto", "projected", "params3d"])
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--trace-out", default=None,
                    help="write per-step span trace (JSONL; .chrome.json sibling for Perfetto)")
    ap.add_argument("--metrics-out", default=None, help="write final train.* registry snapshot as JSON")
    ap.add_argument("--trace-capacity", type=int, default=65536)
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    ranks = args.data_par * args.model_par
    world = int(os.environ.get("WORLD_SIZE", "1"))
    mesh, owns_group = None, False
    if ranks > 1 or world > 1:
        if not dist.is_initialized() and "WORLD_SIZE" not in os.environ:
            raise SystemExit(f"train: --data-par {args.data_par} --model-par {args.model_par} runs one process per "
                             f"rank; launch it under torchrun: python -m torch.distributed.run --nproc-per-node "
                             f"{ranks} -m repro_torch.launch.train ...")
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        if not dist.is_initialized():
            init_ranks(device)
            owns_group = True
        mesh = make_gs_mesh(args.data_par, args.model_par, device=device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train: no CUDA device; pass --device cpu to train on the CPU")
    lead = mesh is None or mesh.rank == 0

    obs = Obs(trace=args.trace_out is not None, trace_capacity=args.trace_capacity)
    cfg = GSConfig(
        img_h=args.res, img_w=args.res, batch_size=args.batch,
        k_per_tile=args.k_per_tile, max_steps=max(args.steps, 1),
        gather_mode=args.gather_mode,
        densify_from=100, densify_interval=150, densify_until=max(args.steps - 50, 101),
        opacity_reset_interval=10**9,
    )
    dataset = dict(volume_res=args.volume_res, n_views=args.views, img_h=args.res, img_w=args.res,
                   max_points=args.max_points, device=device)
    if lead:  # rank 0 ray-marches and writes the ground-truth cache; the others read it
        vol, pts, cols, data = build_dataset(args.dataset, **dataset)
    if mesh is not None:
        mesh.barrier()
    if not lead:
        vol, pts, cols, data = build_dataset(args.dataset, **dataset)
    where = f"mesh {mesh.shape} ({mesh.device}, rank 0)" if mesh is not None else f"device {device}"
    if lead:
        print(f"{args.dataset}: {pts.shape[0]} isosurface points, {args.views} views @ {args.res}^2, {where}")
    tr = GSTrainer(cfg, pts, cols, device=device, obs=obs, mesh=mesh, verbose=lead)
    t0 = now()
    losses = tr.fit(data, steps=args.steps)
    train_time = since(t0)
    metrics = tr.evaluate(data, range(0, args.views, max(args.views // 8, 1)))
    if lead:
        print(f"train {train_time:.1f}s  final-loss {losses[-1]:.5f}  {metrics}")
    if args.ckpt:
        rec, rid = obs.trace, new_request_id()
        t_c = now()
        path = save_checkpoint(args.ckpt, int(tr.state.step), tr.state, mesh=mesh)
        if rec:
            rec.record(rid, "ckpt", t_c, now(), step=int(tr.state.step))
        if lead:
            print("checkpoint:", path)
    if args.metrics_out and lead:
        with open(args.metrics_out, "w") as f:
            json.dump(obs.metrics.snapshot(), f, indent=1, sort_keys=True)
        print("metrics:", args.metrics_out)
    if args.trace_out and lead:
        export_trace(obs.trace, args.trace_out, {
            "dataset": args.dataset, "steps": args.steps, "batch": args.batch,
            "data_par": args.data_par, "model_par": args.model_par,
            "device": str(device), "gather_mode": cfg.gather_mode,
        })
    if owns_group:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
