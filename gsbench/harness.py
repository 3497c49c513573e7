"""One cell's run on one rank: set-up, the timed window, the traced steps,
and the comparison with the reference that decides ``correct``.

Set-up makes the cell's model, cameras and ground truth on the card from
the seed (``gsbench/scene``), builds the program's ``GSTrainer`` from them
and drives it through its first three steps with ``GSTrainer.fit`` and the
window's own feed, on twelve distinct views. Those steps' losses, the first
gradient (from Adam's first moment after step 1) and the parameters' change
after step 3 are the program's readings. The train state after those steps
is the snapshot (``Snapshot``, in the host's memory).

The window then runs ``fit`` on the same trainer in stretches of one epoch
of the views, each from the snapshot and the seed's first epoch of batches,
until ``seconds`` of ``fit``'s time have passed. A step's cost changes as
the model trains (the splats grow, and with them the tiles' lists), so
without the snapshot a program that completes more steps would be timed on
other work; with it, every stretch repeats the same steps. With ``trace``
on, the window records ``fit``'s spans, and the first steps of a stretch
from the snapshot run again under ``torch.profiler``: the per-layer
metrics are read at that fixed place, whatever the program's speed. After
the window the program's state is freed and rank 0 runs the reference
(``gsbench/reference``) over the same inputs.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch

GSBENCH = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SETUP_STEPS = 3


def load_json(*parts) -> dict:
    with open(os.path.join(GSBENCH, *parts)) as f:
        return json.load(f)


def load_cell(name: str) -> dict:
    """The cell file with its configuration and traffic, found by name."""
    cell = load_json("workloads", f"{name}.json")
    cell["name"] = name
    cell["config_data"] = load_json("configs", f"{cell['config']}.json")
    cell["traffic_data"] = load_json("traffic", f"{cell['traffic']}.json")
    return cell


def metric_readers() -> dict:
    """Every per-layer metric's reader module in ``gsbench/metrics``, by
    name: its ``read(ctx)`` and its ``UNIT``."""
    out = {}
    folder = os.path.join(GSBENCH, "metrics")
    for fn in sorted(os.listdir(folder)):
        if fn.endswith(".py") and not fn.startswith("_"):
            spec = importlib.util.spec_from_file_location(f"gsbench.metrics.{fn[:-3]}", os.path.join(folder, fn))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            out[fn[:-3]] = mod
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def log(opts: dict, rank: int, what: str) -> None:
    """A progress line on standard error (rank 0): seconds since process start."""
    if rank == 0:
        print(f"gsbench {time.time() - opts['t0']:8.2f} s  {what}", file=sys.stderr, flush=True)


def card_line(index: int = 0) -> str:
    try:
        return subprocess.run(["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


class Feed:
    """The views object ``GSTrainer.fit`` reads: the cell's batches in the
    seed's order, up to ``count`` of them or until the clock passes
    ``until``. ``marks`` holds the time at which ``fit`` asked for each
    batch and, last, the time it asked after the last step. Across ranks,
    ``agree`` turns this rank's wish to stop into the ranks' common one, so
    that every rank runs the same steps."""

    def __init__(self, cams, gt: torch.Tensor, order, *, count: int | None = None, until: float | None = None,
                 agree=None):
        self.cams, self.gt, self.order = cams, gt, order
        self.count, self.until, self.agree = count, until, agree
        self.marks: list[float] = []
        self.views: list[list[int]] = []

    def batches(self, batch_size: int, *, steps: int):
        self.marks = [time.perf_counter()]
        while len(self.views) < steps and (self.count is None or len(self.views) < self.count):
            if self.until is not None:
                stop = self.marks[-1] >= self.until
                if self.agree is not None:
                    stop = self.agree(stop)
                if stop:
                    break
            views = next(self.order)
            if len(views) != batch_size:
                raise ValueError(f"a batch of {len(views)} views for a step of {batch_size}")
            self.views.append(views)
            idx = torch.tensor(views)
            yield type(self.cams)(*[x[idx] for x in self.cams]), self.gt[idx.to(self.gt.device)]
            self.marks.append(time.perf_counter())


def _state_tensors(state) -> list[torch.Tensor]:
    """Every tensor of a train state (a tree of named tuples), in order."""
    if isinstance(state, torch.Tensor):
        return [state]
    return [t for x in state for t in _state_tensors(x)]


class Snapshot:
    """A trainer's whole train state, kept in the host's pinned memory so
    that the card's peak holds none of it. ``restore`` copies it back into
    the trainer's state in place and waits for the copy."""

    def __init__(self, tr):
        self.host = [t.detach().to("cpu", copy=True) for t in _state_tensors(tr.state)]
        if tr.device.type == "cuda":
            self.host = [h.pin_memory() for h in self.host]

    @torch.no_grad()
    def restore(self, tr) -> None:
        for t, h in zip(_state_tensors(tr.state), self.host, strict=True):
            t.copy_(h, non_blocking=True)
        if tr.device.type == "cuda":
            torch.cuda.synchronize(tr.device)


def run_window(tr, snap: Snapshot, cams, gt, new_order, seconds: float, stretch: int, agree=None) -> dict:
    """``GSTrainer.fit`` in stretches of ``stretch`` steps, each from the
    snapshot and ``new_order()``'s first batches, until ``seconds`` of
    ``fit``'s own time (first batch asked to last step done, a stretch) have
    passed; the restores between stretches are not timed. The window ends
    on a step boundary."""
    out = {"losses": [], "step_ms": [], "window_s": 0.0, "steps": 0}
    while True:
        feed = Feed(cams, gt, new_order(), count=stretch, until=time.perf_counter() + seconds - out["window_s"],
                    agree=agree)
        out["losses"] += tr.fit(feed, steps=stretch, densify=False, log_every=10**9)
        out["window_s"] += feed.marks[-1] - feed.marks[0]
        out["step_ms"] += tr.step_ms_log
        out["steps"] += len(feed.views)
        if len(feed.views) < stretch:
            return out
        snap.restore(tr)


def gs_config(cell: dict):
    from repro_torch.core.config import GSConfig

    gs, traffic = cell["config_data"]["gs"], cell["traffic_data"]
    names = {f.name for f in dataclasses.fields(GSConfig)}
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in gs.items() if k in names}
    return GSConfig(img_h=traffic["res"], img_w=traffic["res"], batch_size=traffic["batch"], **kw)


def _sum_over(x: torch.Tensor, mesh) -> torch.Tensor:
    if mesh is not None:
        torch.distributed.all_reduce(x, group=mesh.model.group)
    return x


def _leaf_norms(leaves, mesh, scale: float = 1.0) -> list[float]:
    sq = torch.stack([(x.double() * scale).square().sum() for x in leaves])
    return [math.sqrt(float(v)) for v in _sum_over(sq, mesh)]


def program_readings(tr, cams, gt, order, mesh) -> dict:
    """Drive the trainer through its first steps with ``fit`` and the
    window's feed; read its losses, first gradient and change."""
    b1 = 0.9  # the program's Adam: m after one step is (1 - b1) g
    p0 = [x.detach().cpu() for x in tr.state.params]
    feed = Feed(cams, gt, order, count=1)
    losses = tr.fit(feed, steps=1, densify=False, log_every=10**9)
    grads = _leaf_norms(tr.state.adam.m, mesh, 1.0 / (1.0 - b1))
    views = list(feed.views)
    feed = Feed(cams, gt, order, count=SETUP_STEPS - 1)
    losses += tr.fit(feed, steps=SETUP_STEPS - 1, densify=False, log_every=10**9)
    views += feed.views
    dev = tr.state.params.means.device
    change = _leaf_norms([x - p.to(dev) for x, p in zip(tr.state.params, p0)], mesh)
    return {"losses": [float(v) for v in losses], "grad_norms": grads, "change_norms": change, "views": views}


def gaps(prog: dict, ref: dict, fields) -> dict:
    """The numbers compared: the worst step's relative loss gap, and by the
    worst leaf the gap between the program's and the reference's norms of
    the first gradient and of the change after the set-up steps, each over
    the larger of the leaf's and the median leaf's reference norm. Leaves
    whose reference gradient is under a thousandth of the median leaf's are
    left out of the change (they move by round-off alone)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    g_ref = [ref["grad_norms"][f] for f in fields]
    med = statistics.median(g_ref)
    grad = max(abs(a - b) / max(b, med) for a, b in zip(prog["grad_norms"], g_ref))
    keep = [i for i, f in enumerate(fields) if g_ref[i] >= 1e-3 * med]
    c_ref = [ref["change_norms"][fields[i]] for i in keep]
    med_c = statistics.median(c_ref)
    change = max(abs(prog["change_norms"][i] - b) / max(b, med_c) for i, b in zip(keep, c_ref))
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def reference_readings(cell: dict, seed: int, cams: dict, gt: torch.Tensor, views: list, dev, *,
                       tf32: bool = False) -> dict:
    from gsbench.reference.step import train_steps
    from gsbench.scene import make_scene

    scene, _ = make_scene(cell["config_data"], seed, dev)
    return train_steps(scene, cams, gt, views, cell["config_data"], tf32=tf32)


def setup(rank: int, world: int, opts: dict):
    """Device, mesh and the benchmark's inputs for this rank."""
    from repro_torch.core.projection import Camera
    from repro_torch.launch.mesh import init_ranks, make_gs_mesh

    from gsbench.scene import make_views

    cell = opts["cell"]
    dev = torch.device("cuda", rank) if opts["device"] == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        # float32 as the configurations state: the reference's products and
        # SSIM window must not run in TF32 (cuDNN's default)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(opts.get("cpu_threads", 1))
    mesh = None
    if world > 1:
        init_ranks(dev, init_method=f"file://{opts['rendezvous']}", rank=rank, world_size=world,
                   timeout_s=opts.get("collective_timeout_s", 600.0))
        mesh = make_gs_mesh(*cell["mesh"], device=dev)
    cams, gt = make_views(cell["config_data"], cell["traffic_data"], dev)
    return dev, mesh, cams, Camera(*[cams[f] for f in Camera._fields]), gt


def build_trainer(cell: dict, seed: int, dev, mesh, trace: bool):
    from repro_torch.core import gaussians as G
    from repro_torch.launch.train import GSTrainer
    from repro_torch.obs import Obs

    from gsbench.scene import FIELDS, make_scene

    scene, n_surface = make_scene(cell["config_data"], seed, dev)
    n_total = scene["means"].shape[0]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    tr = GSTrainer(gs_config(cell), params=G.GaussianModel(*[scene[f] for f in FIELDS]), device=dev, mesh=mesh,
                   obs=Obs(trace=trace), verbose=False)
    del scene
    return tr, n_total, n_surface


def _readers_ctx(tr, cell, prof, steps, wall_ms, spans, window_step_ms, mesh) -> types.SimpleNamespace:
    from gsbench.work import step_work

    traffic, gs = cell["traffic_data"], cell["config_data"]["gs"]
    n_local = tr.state.params.n
    strips = mesh.model.size if (mesh is not None and gs["pixel_parallel"]) else 1
    views = traffic["batch"] // (mesh.data.size if mesh is not None else 1)
    work = step_work(n_local, views, views * traffic["res"] * traffic["res"] // strips, gs["sh_degree"])
    return types.SimpleNamespace(prof=prof, steps=steps, wall_ms=wall_ms, spans=spans, window_step_ms=window_step_ms,
                                 step_work=work, n_local=n_local, sh_coeffs=(gs["sh_degree"] + 1) ** 2)


def run_rank(rank: int, world: int, opts: dict) -> dict | None:
    """One rank of one run. Rank 0 returns the result (and writes it to
    ``opts['result_path']`` when given); the others return None."""
    dev, mesh, cams, prog_cams, gt = setup(rank, world, opts)
    undo = None
    if opts.get("fault"):
        from gsbench.faults import plant
        undo = plant(opts["fault"])
    try:
        return _run(rank, world, opts, dev, mesh, cams, prog_cams, gt)
    finally:
        if undo is not None:
            undo()


def _run(rank, world, opts, dev, mesh, cams, prog_cams, gt):
    from gsbench.scene import batch_order

    cell, seed, trace = opts["cell"], opts["seed"], opts["trace"]
    traffic = cell["traffic_data"]
    cuda = dev.type == "cuda"
    log(opts, rank, "inputs made")
    tr, n_total, n_surface = build_trainer(cell, seed, dev, mesh, trace)
    log(opts, rank, f"trainer built: {n_total} Gaussians from {n_surface} surface points")
    n_views = cell["config_data"]["views"]

    def new_order():
        return batch_order(n_views, traffic["batch"], seed)

    prog = program_readings(tr, prog_cams, gt, new_order(), mesh)
    snap = Snapshot(tr)
    if trace:
        tr.obs.trace.drain()
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.time() - opts["t0"]
    log(opts, rank, f"set-up steps done, losses {prog['losses']}")

    agree = None
    if mesh is not None:
        flag = torch.zeros(1, device=dev)

        def agree(stop: bool) -> bool:  # any rank past the deadline stops them all
            flag.fill_(float(stop))
            torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MAX)
            return bool(flag.item())

        mesh.barrier()
    win = run_window(tr, snap, prog_cams, gt, new_order, opts["seconds"], n_views // traffic["batch"], agree)
    window_s, steps, step_log = win["window_s"], win["steps"], win["step_ms"]
    failed = sum(1 for v in win["losses"] if not math.isfinite(v))
    peak = torch.tensor([float(torch.cuda.max_memory_allocated(dev)) if cuda else 0.0], device=dev)
    if mesh is not None:
        torch.distributed.all_reduce(peak, op=torch.distributed.ReduceOp.MAX)
    peak = int(peak.item())
    log(opts, rank, f"window done: {steps} steps in {window_s:.3f} s")

    per_layer, busy, breakdown_ = {}, None, None
    if trace:
        spans = [(s.name, s.t0, s.t1) for s in tr.obs.trace.drain()]
        tr.obs.disable_trace()
        prof_steps = traffic["profile_steps"]
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        snap.restore(tr)  # the profiled steps are a stretch's first, from the snapshot
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            tr.fit(Feed(prog_cams, gt, new_order(), count=prof_steps), steps=prof_steps, densify=False,
                   log_every=10**9)
            if cuda:
                torch.cuda.synchronize(dev)
            wall_ms = (time.perf_counter() - t0) * 1e3
        from gsbench.profread import breakdown, device_rows, union_ms

        busy_ms = union_ms([(s, e) for _, s, e in device_rows(prof)])
        both = torch.tensor([busy_ms, wall_ms], dtype=torch.float64, device=dev)
        if mesh is not None:
            torch.distributed.all_reduce(both, group=mesh.model.group)
        busy = (float(both[0]) / world / 1e3, float(both[1]) / world / 1e3)
        if rank == 0:
            ctx = _readers_ctx(tr, cell, prof, prof_steps, wall_ms, spans, 1e3 * window_s / steps, mesh)
            for name, mod in metric_readers().items():
                v = mod.read(ctx)
                if v is not None:
                    per_layer[name] = {"value": float(v), "unit": mod.UNIT}
            breakdown_ = breakdown(prof)
        del prof
        log(opts, rank, "profiled steps read")

    del tr, snap
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = None
    if rank == 0:
        ref = reference_readings(cell, seed, cams, gt, prog["views"], dev)
        log(opts, rank, f"reference done, losses {ref['losses']}")
    if mesh is not None:
        mesh.barrier()
    found = forbidden_modules()
    if mesh is not None:
        every = [None] * world
        torch.distributed.all_gather_object(every, found)
        found = sorted({m for f in every for m in f})
        torch.distributed.destroy_process_group()
    if rank != 0:
        return None

    from gsbench.scene import FIELDS

    compared = gaps(prog, ref, FIELDS)
    limits = cell["limits"]
    correct = (failed == 0 and steps > 0 and all(math.isfinite(v) for v in prog["losses"])
               and all(compared[k] <= limits[k] for k in limits))
    if trace:
        metrics = per_layer
    else:
        metrics = {
            "step_ms": {"value": 1e3 * window_s / steps if steps else float("nan"), "unit": "ms"},
            "step_ms_p90": {"value": float(np.percentile(step_log, 90)) if step_log else float("nan"), "unit": "ms"},
            "peak_mem_gb": {"value": peak / 1e9, "unit": "GB"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu", "count": world,
              "memory_peak_bytes": peak}
    if busy is not None:
        device["busy_s"], device["window_s"] = busy
    result = {"correct": bool(correct), "attempted": steps, "failed": failed, "metrics": metrics, "device": device}
    if breakdown_ is not None:
        result["breakdown"] = breakdown_
    result["forbidden_modules"] = found
    result["card"] = card_line() if cuda else "cpu"
    result["scene"] = {"gaussians": n_total, "surface_points": n_surface, "window_steps": steps,
                       "window_s": window_s, "setup_losses": prog["losses"], "reference_losses": ref["losses"]}
    result["compared"] = {k: {"value": compared[k], "limit": limits[k]} for k in compared}
    if opts.get("result_path"):
        with open(opts["result_path"], "w") as f:
            json.dump(result, f)
    return result
