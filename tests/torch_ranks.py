"""Spawned gloo ranks for the PyTorch port's multi-rank parity tests
(``tests/test_torch_sharding.py``, ``tests/test_torch_train_ranks.py``,
``tests/test_torch_serve_ranks.py``, ``tests/test_torch_insitu_ranks.py``,
``tests/test_torch_train_trace.py``).

``spawn(tasks, world, inputs, tmp)`` starts ``world`` processes of this file,
one per rank. They meet through a ``file://`` store under ``tmp`` (no fixed
port: several pytest workers share the host), run every task in order on
their own (data, model) mesh, and each writes its outputs to
``rank<r>.npz``. Every wait has a timeout, so a hang fails the test instead
of stalling the run. The worker imports torch and the port only.
``start`` and ``finish`` split ``spawn`` so that several runs go at once;
``finish(..., check=False)`` returns every rank's exit code and output
instead of asserting that all exited 0.

A task is a dict with a ``kind`` (a function of this module), a ``name``
that prefixes its outputs, a ``mesh`` [data, model] and its own keys.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 150


def spawn(tasks: list[dict], world: int, inputs: dict, tmp: Path, timeout_s: float = RANK_TIMEOUT_S,
          device: str = "cpu") -> list[dict]:
    """Run ``tasks`` on ``world`` ranks: gloo on the CPU, or NCCL with one
    rank per card (``device="cuda"``); returns each rank's outputs."""
    return finish(start(tasks, world, inputs, tmp, device), timeout_s)


def start(tasks: list[dict], world: int, inputs: dict, tmp: Path, device: str = "cpu") -> tuple:
    """Start the ``world`` rank processes of a run; returns its handle."""
    tmp.mkdir(parents=True, exist_ok=True)
    np.savez(tmp / "inputs.npz", **inputs)
    (tmp / "tasks.json").write_text(json.dumps({"world": world, "tasks": tasks, "device": device}))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, str(tmp), str(r)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    return tmp, procs


def finish(run: tuple, timeout_s: float = RANK_TIMEOUT_S, check: bool = True):
    """Wait for a started run. With ``check``, assert that every rank exited
    0 and return each rank's outputs; else return (exit codes, outputs)."""
    tmp, procs = run
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout_s)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if not check:
        return [p.returncode for p in procs], logs
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n" + logs[r][-4000:]
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(len(procs))]


# ------------------------------------------------------------------ worker


def _state(inp: dict, prefix: str = "state."):
    from repro_torch.core import gaussians as G
    from repro_torch.core.train import GSTrainState
    from repro_torch.optim.adam import AdamState

    def f(k):
        return inp[prefix + k]

    def model(p):
        return G.GaussianModel(*[f(f"{p}.{n}") for n in G.GaussianModel._fields])

    return GSTrainState(params=model("params"), adam=AdamState(model("adam.m"), model("adam.v"), f("adam.count")),
                        step=f("step"), grad2d_accum=f("grad2d_accum"), vis_count=f("vis_count"),
                        max_radii=f("max_radii"))


def flat_state(state, prefix: str) -> dict:
    """A train state as flat numpy arrays under dotted keys (``prefix`` +
    ``params.means``, ``adam.m.sh``, ``step`` ...)."""
    from repro_torch.core.train import state_to_numpy

    h = state_to_numpy(state)
    out = {f"{prefix}step": h.step, f"{prefix}adam.count": h.adam.count, f"{prefix}grad2d_accum": h.grad2d_accum,
           f"{prefix}vis_count": h.vis_count, f"{prefix}max_radii": h.max_radii}
    for part, m in (("params", h.params), ("adam.m", h.adam.m), ("adam.v", h.adam.v)):
        for name, x in zip(m._fields, m):
            out[f"{prefix}{part}.{name}"] = x
    return out


def train(mesh, task, inp) -> dict:
    """Steps from the same state on the same batch; with ``one_device`` the
    same steps without a mesh, from the same state."""
    import torch

    from repro_torch.core.config import GSConfig
    from repro_torch.core.projection import Camera
    from repro_torch.core.train import make_train_step, shard_state, state_from_numpy

    cfg = GSConfig(**task["cfg"])
    cams = Camera(*[torch.tensor(inp[f"{task['inputs']}cams.{f}"]) for f in Camera._fields])
    gt = torch.tensor(inp[f"{task['inputs']}gt"], device=mesh.device)
    full = state_from_numpy(_state(inp, f"{task['inputs']}state."), mesh.device)
    runs = {"": (make_train_step(cfg, mesh), shard_state(full, mesh))}
    if task.get("one_device"):
        runs["one_device."] = (make_train_step(cfg), full)
    out = {}
    for key, (step, st) in runs.items():
        losses = []
        for i in range(task["steps"]):
            st, m = step(st, cams, gt)
            losses.append(float(m["loss"]))
            if i == 0:
                out.update(flat_state(st, f"{key}step1."))
        out[f"{key}losses"] = np.asarray(losses)
        out.update(flat_state(st, f"{key}final."))
    return out


def traced_fit(mesh, task, inp) -> dict:
    """``GSTrainer.fit`` with tracing on, from the full state on the batch
    ``inp`` holds, ``task["steps"]`` times; its spans as arrays (name, rid,
    step, view (-1: none), t0, t1)."""
    import torch

    from repro_torch.core.config import GSConfig
    from repro_torch.core.projection import Camera
    from repro_torch.launch.train import GSTrainer
    from repro_torch.obs import Obs

    cfg = GSConfig(**task["cfg"])
    cams = Camera(*[torch.tensor(inp[f"{task['inputs']}cams.{f}"]) for f in Camera._fields])
    gt = torch.tensor(inp[f"{task['inputs']}gt"], device=mesh.device)
    full = _state(inp, f"{task['inputs']}state.")
    tr = GSTrainer(cfg, params=[torch.tensor(x) for x in full.params], mesh=mesh, obs=Obs(trace=True),
                   verbose=False)

    class Feed:
        def batches(self, batch_size, *, steps):
            for _ in range(steps):
                yield cams, gt

    tr.fit(Feed(), steps=task["steps"], densify=False)
    spans = tr.obs.trace.drain()
    return {"names": np.asarray([s.name for s in spans]), "rid": np.asarray([s.rid for s in spans]),
            "step": np.asarray([s.meta.get("step", -1) for s in spans]),
            "view": np.asarray([s.meta.get("view", -1) for s in spans]),
            "t0": np.asarray([s.t0 for s in spans]), "t1": np.asarray([s.t1 for s in spans])}


def loss(mesh, task, inp) -> dict:
    """The strip's (ssim, l1, count) sums per image and the gradient of
    ``distributed_gs_loss`` with respect to the strip."""
    import torch

    from repro_torch.core import sharding as S

    pred, gt = torch.tensor(inp[f"{task['inputs']}pred"]), torch.tensor(inp[f"{task['inputs']}gt"])
    h = pred.shape[1] // mesh.model.size
    rows = slice(mesh.model.index * h, (mesh.model.index + 1) * h)
    p, g = pred[:, rows].clone().requires_grad_(), gt[:, rows]
    sums = np.asarray([[float(x) for x in S.ssim_l1_sums(p[i], g[i], mesh.model)] for i in range(p.shape[0])])
    value = S.distributed_gs_loss(p, g, lam=0.2, strip_axis=mesh.model, reduce_axes=(mesh.data, mesh.model))
    (grad,) = torch.autograd.grad(value, p)
    return {"sums": sums, "loss": np.asarray(float(value)), "grad": grad.numpy()}


def balance(mesh, task, inp) -> dict:
    """``shard_balance`` of this rank's shard of a full state, and the
    gauges ``record_shard_balance`` lands."""
    from repro_torch.core.train import record_shard_balance, shard_balance, shard_state, state_from_numpy
    from repro_torch.obs import MetricsRegistry

    st = shard_state(state_from_numpy(_state(inp, f"{task['inputs']}state."), "cpu"), mesh)
    bal = shard_balance(st, mesh)
    reg = MetricsRegistry()
    record_shard_balance(reg, bal)
    return {"balance": np.asarray(json.dumps(bal)), "snapshot": np.asarray(json.dumps(reg.snapshot()))}


def densify(mesh, task, inp) -> dict:
    """One densify round on this rank's shard with the shared generator;
    ``gather_state`` of the input shard; the new shards saved as one
    checkpoint under ``task["ckpt"]`` and restored onto the mesh."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.core.config import GSConfig
    from repro_torch.core.densify import densify_and_rebalance
    from repro_torch.core.train import gather_state, shard_state, state_from_numpy

    st = shard_state(state_from_numpy(_state(inp, f"{task['inputs']}state."), "cpu"), mesh)
    new, rep = densify_and_rebalance(st, GSConfig(**task["cfg"]), n_shards=mesh.model.size, mesh=mesh,
                                     rng=np.random.default_rng(task["seed"]))
    save_checkpoint(task["ckpt"], int(new.step), new, mesh=mesh)
    back = restore_checkpoint(task["ckpt"], int(new.step), new, mesh=mesh)
    return {**flat_state(new, "shard."), **flat_state(gather_state(st, mesh), "gathered."),
            **flat_state(back, "restored."), "report": np.asarray(tuple(rep))}


def _model(inp: dict, prefix: str):
    from repro_torch.core import gaussians as G

    return G.GaussianModel(*[inp[f"{prefix}{f}"] for f in G.GaussianModel._fields])


def serve_scenario(srv, inp: dict, pre: str) -> dict:
    """The lead's requests, in the order the JAX oracle makes them: every
    camera once (batched misses at both levels), every camera again (cache
    hits), two after ``invalidate(rows={1})`` (partial hits: strips), two
    after ``add_timestep(changed=...)`` (the dirty rows re-render). Returns
    the frames of each round and the server's counts."""
    from repro_torch.core.projection import Camera

    cams = [Camera(*[inp[f"{pre}cams.{f}"][i] for f in Camera._fields]) for i in range(len(inp[f"{pre}cams.fx"]))]
    out = {}

    def serve(name, group):
        futs = [srv.submit(c) for c in group]
        srv.run()
        out[f"frames.{name}"] = np.stack([f.result() for f in futs])

    serve("miss", cams)
    serve("hit", cams)
    srv.invalidate(0, rows={1})
    serve("partial", [cams[0], cams[-1]])
    srv.add_timestep(0, _model(inp, f"{pre}new."), changed=inp[f"{pre}changed"])
    serve("changed", cams[:2])
    rep = srv.report()
    out["counts"] = np.asarray([rep["completed"], rep["tiles"]["full_hits"], rep["tiles"]["partial_hits"],
                                rep["tiles"]["frame_misses"], rep["tiles"]["rows_rendered_partial"],
                                rep["render"]["calls"], *rep["lod"]["requests_per_level"]])
    out["buckets"] = np.asarray(srv.batcher.buckets)
    return out


def serve(mesh, task, inp) -> dict:
    """``RenderServer(mesh=...)``: the lead runs :func:`serve_scenario` and
    closes, the followers serve until it does; with ``one_device`` the lead
    then runs the same requests through a ``mesh=None`` server. With
    ``max_batches`` the lead only reads each such server's buckets."""
    from repro_torch.core.config import GSConfig
    from repro_torch.serve_gs import RenderServer

    cfg, pre = GSConfig(**task["cfg"]), task["inputs"]
    params = _model(inp, f"{pre}params.")
    out = {}
    for mb in task.get("max_batches", []):
        with RenderServer(params, cfg, mesh=mesh, **dict(task["server"], max_batch=mb)) as srv:
            if srv.is_lead:
                out[f"buckets.{mb}"] = np.asarray(srv.batcher.buckets)
            else:
                srv.serve_follower()
    with RenderServer(params, cfg, mesh=mesh, **task["server"]) as srv:
        if not srv.is_lead:
            srv.serve_follower()
            return {**out, "followed": np.asarray(1)}
        out.update(serve_scenario(srv, inp, pre))
        out["mesh_report"] = np.asarray(json.dumps(srv.report()["mesh"]))
    if task.get("one_device"):
        with RenderServer(params, cfg, device=mesh.device, **task["server"]) as srv:
            out.update({f"one_device.{k}": v for k, v in serve_scenario(srv, inp, pre).items()})
    return out


def serve_refuses(mesh, task, inp) -> dict:
    """A model whose row count does not divide by the model axis: every
    rank's constructor raises ValueError; returns its message."""
    from repro_torch.core.config import GSConfig
    from repro_torch.serve_gs import RenderServer

    try:
        RenderServer(_model(inp, f"{task['inputs']}params."), GSConfig(**task["cfg"]), mesh=mesh, **task["server"])
    except ValueError as e:
        return {"error": np.asarray(str(e))}
    raise AssertionError("RenderServer accepted a model that does not split over the model axis")


def serve_abort(mesh, task, inp) -> dict:
    """The lead fails mid-serve: inside ``with`` (``__exit__`` sends the
    abort op) or outside it (the process dies with its control group). The
    followers must raise, not wait: their rank exits non-zero."""
    from repro_torch.core.config import GSConfig
    from repro_torch.core.projection import Camera
    from repro_torch.serve_gs import RenderServer

    pre = task["inputs"]
    srv = RenderServer(_model(inp, f"{pre}params."), GSConfig(**task["cfg"]), mesh=mesh, **task["server"])
    if not srv.is_lead:
        t0 = time.perf_counter()
        try:
            srv.serve_follower()
        finally:
            print(f"follower served for {time.perf_counter() - t0:.3f} s", flush=True)
        return {"followed": np.asarray(1)}
    cam = Camera(*[inp[f"{pre}cams.{f}"][0] for f in Camera._fields])
    if task["inside_with"]:
        with srv:
            srv.submit(cam).result()
            raise RuntimeError("the lead fails mid-serve")
    srv.submit(cam).result()
    raise RuntimeError("the lead fails mid-serve, outside a with block")


def insitu(mesh, task, inp) -> dict:
    """``InsituTrainer(mesh=...)`` over a synthetic stream (``task["stream"]``:
    ``synthetic_stream``'s arguments); rank 0 keeps a temporal store under
    ``task["store"]``. Every rank returns its step losses, the slots each
    timestep reseeded and its reports' numbers."""
    from repro_torch.core.config import GSConfig
    from repro_torch.insitu import InsituTrainer, TemporalCheckpointStore
    from repro_torch.volume.timevary import synthetic_stream

    tr = InsituTrainer(GSConfig(**task["cfg"]), mesh, **task["trainer"])
    store = TemporalCheckpointStore(task["store"], keyframe_interval=2) if mesh.rank == 0 else None
    reports = tr.run(synthetic_stream(**task["stream"]), store=store)
    if store is not None:
        store.close()
    out = {"losses": np.asarray(tr.step_losses), "n_traces": np.asarray(tr.n_traces),
           "reports": np.asarray([[r.n_reseeded, r.loss_final, r.psnr_before, r.psnr_after] for r in reports]),
           "changed": np.asarray([len(r.changed_slots or ()) for r in reports])}
    out.update({f"reseed.{i}": s for i, s in enumerate(tr.reseed_log)})
    return out


def main(tmp: str, rank: int) -> None:
    import torch

    from repro_torch.launch.mesh import init_ranks, make_gs_mesh

    torch.set_num_threads(1)
    spec = json.loads((Path(tmp) / "tasks.json").read_text())
    device = torch.device("cuda", rank) if spec["device"] == "cuda" else torch.device("cpu")
    init_ranks(device, init_method=f"file://{tmp}/store", rank=rank, world_size=spec["world"], timeout_s=120)
    inp = dict(np.load(Path(tmp) / "inputs.npz"))
    out = {}
    for task in spec["tasks"]:
        mesh = make_gs_mesh(*task["mesh"], device=device)
        res = globals()[task["kind"]](mesh, task, inp)
        out.update({f"{task['name']}/{k}": v for k, v in res.items()})
        out[f"{task['name']}/coords"] = np.asarray([mesh.data.index, mesh.model.index])
    np.savez(Path(tmp) / f"rank{rank}.npz", **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
