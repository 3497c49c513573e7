"""Warm-start incremental trainer for streaming time-varying volumes
(PyTorch port of the JAX package's ``insitu/trainer.py``).

The static pipeline (``repro_torch.launch.train``) pays two costs per volume
that a stream cannot afford: a from-scratch optimization and, through
densification's shape changes, a train step whose shapes keep moving. This
trainer fixes both:

  * **Fixed padded capacity.** The Gaussian count is padded once, at the
    first timestep, to ``capacity`` (a shard-aligned multiple of
    ``n_shards * cfg.pad_quantum``). Every later timestep reuses the same
    shapes. The JAX package counts this as one jit trace for the whole
    sequence; the port has no trace, so ``n_traces`` counts the distinct
    shape signatures the train step has been called with, which stays 1.

  * **Warm start + dead-slot reseeding.** Params *and* Adam moments carry
    over from timestep t to t+1; only ``warm_steps`` delta-optimization
    steps run (vs ``cold_steps`` at t=0). Instead of densification, dead
    slots (padding + pruned-to-transparent Gaussians) are re-seeded from the
    new timestep's isosurface extraction, on the host in numpy with the
    trainer's generator and the JAX package's draws in the same order, so
    both packages refill the same slots.

On a CUDA device the train step, the eval views and the served frames run
the hand-written projection and rasterizer kernels. On a (data, model)
``Mesh`` (one process per rank) each rank holds its model shard; the reseed
gathers the full state on every rank, which draws the same slots from the
same generator and keeps its own shard, so the ranks agree without sending
any slot.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from repro_torch.core import gaussians as G
from repro_torch.core.config import GSConfig
from repro_torch.core.densify import DEAD_LOGIT
from repro_torch.core.losses import psnr
from repro_torch.core.sharding import Mesh
from repro_torch.core.train import (
    GSTrainState,
    all_gather_bytes_per_step,
    gather_state,
    init_state,
    make_eval_render,
    make_train_step,
    record_shard_balance,
    shard_balance,
    shard_state,
    state_to_numpy,
)
from repro_torch.data.views import ViewDataset
from repro_torch.obs import Obs, devmem, new_request_id
from repro_torch.obs.clock import now, since
from repro_torch.serve_gs.footprint import changed_indices
from repro_torch.utils.tree import tree_leaves
from repro_torch.volume.datasets import VolumeSpec
from repro_torch.volume.isosurface import extract_isosurface_points


@dataclasses.dataclass
class TimestepReport:
    """What happened while absorbing one stream timestep."""

    t_index: int
    name: str
    mode: str                 # "cold" | "warm"
    steps: int
    n_extracted: int          # isosurface points pulled from this timestep
    n_reseeded: int           # dead slots re-seeded from them
    psnr_before: float        # eval view, before this timestep's training
    psnr_after: float
    loss_final: float
    wall_s: float             # extraction + GT render + train + eval
    train_s: float            # optimization only
    n_traces: int             # distinct train-step shape signatures so far (must stay 1)
    psnr_curve: list = dataclasses.field(default_factory=list)  # [(step, psnr)]
    # Gaussian slots this timestep rewrote (reseeded + optimizer-moved rows),
    # diffed host-side against the previous timestep's params. None means
    # unknown/everything (cold start), exactly what a serving tier should
    # assume. Feeds RenderServer.add_timestep(..., changed=...) so the
    # trainer->server handoff needs no caller-side row math.
    changed_slots: list | None = None


def fixed_capacity_init(
    points: np.ndarray,
    colors: np.ndarray,
    capacity: int,
    *,
    sh_degree: int = 0,
    init_scale: float = 0.05,
    device="cuda",
) -> G.GaussianModel:
    """Init a model at exactly ``capacity`` slots on ``device``; extra slots
    are dead (``DEAD_LOGIT``, means at the 1e6 sentinel)."""
    n0 = points.shape[0]
    assert n0 <= capacity, (n0, capacity)
    pad = capacity - n0
    pts = np.concatenate([np.asarray(points, np.float32), np.full((pad, 3), 1e6, np.float32)])
    cols = np.concatenate([np.asarray(colors, np.float32), np.zeros((pad, 3), np.float32)])
    g = G.init_from_points(pts, cols, sh_degree=sh_degree, init_scale=init_scale, device=device)
    g.opacity_logit[n0:] = DEAD_LOGIT
    return g


def _host_copy(model: G.GaussianModel) -> G.GaussianModel:
    """A numpy copy that no later write to ``model``'s tensors can reach."""
    return G.GaussianModel(*[np.array(x) for x in G.to_numpy(model)])


def reseed_dead_slots(
    state: GSTrainState,
    points: np.ndarray,
    colors: np.ndarray,
    *,
    init_scale: float = 0.05,
    init_opacity: float = 0.1,
    opacity_thresh: float = 0.005,
    max_fraction: float = 1.0,
    rng: np.random.Generator | None = None,
) -> tuple[GSTrainState, int, np.ndarray]:
    """Re-seed dead capacity from a fresh isosurface extraction (host-side).

    Dead = opacity below ``opacity_thresh`` (covers both padding at
    ``DEAD_LOGIT`` and Gaussians the optimizer pruned to transparency). Up to
    ``max_fraction`` of the dead slots are refilled with randomly sampled new
    surface points; their Adam moments and densify stats are zeroed so the
    optimizer treats them as newborn, while the Adam count and the step
    carry on. Shapes are untouched. ``state`` is a full (unsharded) state;
    the new one lands on its device. Returns ``(state, n_fill, slots)``
    where ``slots`` are the refilled row indices, sorted (empty when nothing
    was reseeded).
    """
    rng = rng or np.random.default_rng(0)
    h = state_to_numpy(state)
    p = h.params
    opac = 1.0 / (1.0 + np.exp(-np.clip(p.opacity_logit, -60, 60)))
    dead = np.nonzero(opac < opacity_thresh)[0]
    points = np.asarray(points, np.float32)
    colors = np.asarray(colors, np.float32)
    n_fill = min(int(len(dead) * max_fraction), points.shape[0])
    if n_fill == 0:
        return state, 0, np.zeros(0, np.int64)
    slots = dead[rng.choice(len(dead), n_fill, replace=False)] if n_fill < len(dead) else dead
    pick = rng.choice(points.shape[0], n_fill, replace=False)

    seed = G.to_numpy(fixed_capacity_init(points[pick], colors[pick], n_fill, sh_degree=p.sh_degree,
                                          init_scale=init_scale, device="cpu"))
    seed = seed._replace(opacity_logit=np.full((n_fill,), float(np.log(init_opacity / (1 - init_opacity))),
                                               np.float32))

    new_params = G.GaussianModel(*[a.copy() for a in p])
    for field in G.GaussianModel._fields:
        getattr(new_params, field)[slots] = getattr(seed, field)

    def zero_rows(tree):
        out = G.GaussianModel(*[a.copy() for a in tree])
        for leaf in out:
            leaf[slots] = 0.0
        return out

    m = zero_rows(h.adam.m)
    v = zero_rows(h.adam.v)
    stats = []
    for s in (h.grad2d_accum, h.vis_count, h.max_radii):
        a = s.copy()
        a[slots] = 0.0
        stats.append(a)

    dev = state.params.means.device
    new_state = GSTrainState(
        params=G.from_numpy(new_params, dev),
        adam=state.adam._replace(m=G.from_numpy(m, dev), v=G.from_numpy(v, dev)),
        step=state.step,
        grad2d_accum=torch.from_numpy(stats[0]).to(dev),
        vis_count=torch.from_numpy(stats[1]).to(dev),
        max_radii=torch.from_numpy(stats[2]).to(dev),
    )
    return new_state, n_fill, np.sort(np.asarray(slots, np.int64))


def _signature(*trees) -> tuple:
    """The shapes, dtypes and devices of every leaf: what a compiled step
    would be specialized on."""
    return tuple((tuple(x.shape), x.dtype, x.device) for x in tree_leaves(trees))


class InsituTrainer:
    """Tracks an evolving isosurface with one fixed-shape Gaussian model.

    ``start(vol)`` cold-starts on the first timestep; ``advance(vol)``
    warm-starts every following one; ``run(stream)`` drives a whole
    ``VolumeStream`` (optionally appending params to a
    ``TemporalCheckpointStore`` after each timestep).

    With ``mesh=None`` it trains on ``device`` (default: the card; it raises
    when there is none). With a ``Mesh`` every rank of it constructs a
    trainer and calls the same methods in the same order (they hold
    collectives); the state is this rank's model shard, and ``run``'s store
    and server belong to the caller on rank 0 (pass None on the others).

    Beyond the JAX package's trainer it keeps ``step_losses`` and
    ``step_ms`` (each train step's loss and wall ms, in order, across
    timesteps) and ``reseed_log`` (the slots each ``advance`` refilled);
    ``reset`` clears them.
    """

    def __init__(
        self,
        cfg: GSConfig,
        mesh: Mesh | None = None,
        *,
        device="cuda",
        capacity: int | None = None,
        capacity_factor: float = 1.5,
        cold_steps: int = 200,
        warm_steps: int = 40,
        n_views: int = 8,
        radius: float = 3.0,
        max_points: int | None = 4000,
        n_steps_raymarch: int = 64,
        init_scale: float = 0.05,
        eval_view: int = 0,
        eval_every: int = 0,
        seed: int = 0,
        verbose: bool = False,
        obs: Obs | None = None,
        gt_cache_dir: str | None = None,
    ):
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("InsituTrainer: no CUDA device; pass device='cpu' to train on the CPU")
        self.n_shards = mesh.model.size if mesh is not None else 1
        self.capacity = capacity
        self.capacity_factor = capacity_factor
        self.cold_steps = cold_steps
        self.warm_steps = warm_steps
        self.n_views = n_views
        self.radius = radius
        self.max_points = max_points
        self.n_steps_raymarch = n_steps_raymarch
        self.init_scale = init_scale
        self.eval_view = eval_view
        self.eval_every = eval_every
        self.rng = np.random.default_rng(seed)
        self.verbose = verbose
        # where each timestep's ray-marched ground truth is cached (None:
        # rendered anew for every timestep, as the JAX package does)
        self.gt_cache_dir = gt_cache_dir
        # the observability bundle this trainer reports through: share one
        # with a serving stack (run(server=...)) and training spans land on
        # the same clock/ring as the request spans; standalone trainers get
        # a private bundle so instrumentation never needs a None check
        self.obs = obs if obs is not None else Obs()

        self.state: GSTrainState | None = None
        self.t_index = 0
        self.reports: list[TimestepReport] = []
        self.step_losses: list[float] = []
        self.step_ms: list[float] = []
        self.reseed_log: list[np.ndarray] = []
        self._step_fn = None
        self._eval_fn = None
        self._signatures: set = set()
        self._rid = 0  # request id of the timestep currently being absorbed

    # ------------------------------------------------------------- plumbing
    @property
    def n_traces(self) -> int:
        """Distinct shape signatures of ``(state, cams, gt)`` the train step
        has been called with (the JAX package's jit-trace count)."""
        return len(self._signatures)

    def _dataset(self, vol: VolumeSpec) -> ViewDataset:
        # view-sampling seed derived from the timestep content, not from this
        # trainer's rng position: a warm pipeline and a cold baseline handed
        # the same timestep then draw identical batch orders (fair
        # steps-to-target comparisons in benchmarks/insitu_throughput_torch.py),
        # and so do the two packages
        return ViewDataset(
            vol,
            n_views=self.n_views,
            img_h=self.cfg.img_h,
            img_w=self.cfg.img_w,
            radius=self.radius,
            cache_dir=self.gt_cache_dir,
            n_steps_raymarch=self.n_steps_raymarch,
            seed=zlib.crc32(vol.name.encode()) & 0x7FFFFFFF,
            device=self.device,
        )

    def _host_params(self) -> G.GaussianModel:
        """The full params as a host numpy copy (on a mesh a collective:
        every rank gathers them)."""
        state = self.state if self.mesh is None else gather_state(self.state, self.mesh)
        return _host_copy(state.params)

    @torch.no_grad()
    def _eval_psnr(self, data: ViewDataset) -> float:
        rec = self.obs.trace
        t0 = now() if rec else 0.0
        cam, gt = data.view(self.eval_view % self.n_views)
        img, _ = self._eval_fn(self.state.params, cam)
        p = float(psnr(img, gt))
        if rec:
            rec.record(self._rid, "eval", t0, now(), psnr=round(p, 3))
        self.obs.metrics.gauge("train.psnr").set(round(p, 4))
        return p

    def _fit(self, data: ViewDataset, steps: int, *, psnr0: float) -> tuple[float, list]:
        """The optimization loop of one timestep, instrumented per step:
        ``batch`` (host view assembly) -> ``dispatch`` (the step's launches
        return before the device finishes) -> ``device`` (bounded by a
        device synchronize, traced runs only; an untraced run keeps the
        launch queue full, and the step is bitwise the same either way).
        Wall per step always lands in the ``train.step_ms`` histogram;
        device seconds land in ``train.device_ms`` when tracing bounds them."""
        m = self.obs.metrics
        step_ms = m.histogram("train.step_ms")
        device_ms = m.histogram("train.device_ms")
        loss_gauge = m.gauge("train.loss")
        steps_total = m.counter("train.steps")
        curve = []
        loss = float("nan")
        if self.eval_every > 0:
            curve.append((0, psnr0))  # already measured by the caller
        rid = self._rid
        t_iter = now()
        for i, (cams, gt) in enumerate(data.batches(self.cfg.batch_size, steps=steps)):
            rec = self.obs.trace  # re-read: tracing may toggle mid-fit
            t_batch = now()
            if rec:
                rec.record(rid, "batch", t_iter, t_batch, step=i)
            self._signatures.add(_signature(self.state, cams, gt))
            self.state, metrics = self._step_fn(self.state, cams, gt)
            if rec:
                t_disp = now()
                rec.record(rid, "dispatch", t_batch, t_disp, step=i)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                t_dev = now()
                rec.record(rid, "device", t_disp, t_dev, step=i)
                device_ms.observe((t_dev - t_disp) * 1e3)
            loss = float(metrics["loss"])  # waits for the step either way
            loss_gauge.set(loss)
            steps_total.inc()
            self.step_losses.append(loss)
            self.step_ms.append(since(t_batch) * 1e3)
            step_ms.observe(self.step_ms[-1])
            if self.eval_every > 0 and (i + 1) % self.eval_every == 0:
                curve.append((i + 1, self._eval_psnr(data)))
            t_iter = now()
        return loss, curve

    def reset(self) -> None:
        """Forget the model but keep the step and eval fns (and the shape
        signatures seen): the next ``start()`` at the same capacity adds no
        signature. Lets warm-vs-cold baselines cold-start many timesteps."""
        self.state = None
        self.t_index = 0
        self.reports = []
        self.step_losses = []
        self.step_ms = []
        self.reseed_log = []

    def shard_balance(self, *, record: bool = True) -> dict:
        """Per-model-shard load stats of the current state (see
        :func:`repro_torch.core.train.shard_balance`; a collective on a
        mesh); lands them on the registry (``train.shard_*`` gauges) unless
        ``record=False``."""
        assert self.state is not None, "no model yet"
        bal = shard_balance(self.state, self.mesh, opacity_thresh=self.cfg.prune_opacity_thresh)
        if record:
            record_shard_balance(self.obs.metrics, bal)
        return bal

    # ------------------------------------------------------------ timesteps
    def start(self, vol: VolumeSpec, *, steps: int | None = None) -> TimestepReport:
        assert self.state is None, "start() already called; use advance()"
        t0 = now()
        self._rid = new_request_id()
        rec = self.obs.trace
        pts, _, cols = extract_isosurface_points(vol, max_points=self.max_points)
        if rec:
            rec.record(self._rid, "extract", t0, now(), t_index=self.t_index,
                       points=int(pts.shape[0]), vol=vol.name)
        if self.capacity is None:
            quantum = self.n_shards * self.cfg.pad_quantum
            want = int(pts.shape[0] * self.capacity_factor)
            self.capacity = max(-(-want // quantum) * quantum, quantum)
        assert self.capacity % (self.n_shards * self.cfg.pad_quantum) == 0
        if pts.shape[0] > self.capacity:
            keep = self.rng.choice(pts.shape[0], self.capacity, replace=False)
            pts, cols = pts[keep], cols[keep]
        g = fixed_capacity_init(pts, cols, self.capacity, sh_degree=self.cfg.sh_degree, init_scale=self.init_scale,
                                device=self.device)
        self.state = init_state(g) if self.mesh is None else shard_state(init_state(g), self.mesh)
        if self._step_fn is None:
            self._step_fn = make_train_step(self.cfg, self.mesh)
            self._eval_fn = make_eval_render(self.cfg, self.mesh)
        return self._absorb(vol, pts, cols, 0, steps or self.cold_steps, "cold", t0)

    def advance(self, vol: VolumeSpec, *, steps: int | None = None) -> TimestepReport:
        assert self.state is not None, "advance() before start()"
        t0 = now()
        self._rid = new_request_id()
        rec = self.obs.trace
        pts, _, cols = extract_isosurface_points(vol, max_points=self.max_points)
        if rec:
            rec.record(self._rid, "extract", t0, now(), t_index=self.t_index,
                       points=int(pts.shape[0]), vol=vol.name)
        t_rs = now() if rec else 0.0
        full = self.state if self.mesh is None else gather_state(self.state, self.mesh)
        # params before reseed+training: the diff baseline for changed_slots
        prev_params = _host_copy(full.params)
        full, n_reseeded, slots = reseed_dead_slots(
            full,
            pts,
            cols,
            init_scale=self.init_scale,
            opacity_thresh=self.cfg.prune_opacity_thresh,
            rng=self.rng,
        )
        self.state = full if self.mesh is None else shard_state(full, self.mesh)
        if rec:
            rec.record(self._rid, "reseed", t_rs, now(), t_index=self.t_index,
                       filled=int(n_reseeded))
        self.reseed_log.append(slots)
        self.obs.metrics.counter("train.reseeded").inc(int(n_reseeded))
        return self._absorb(
            vol, pts, cols, n_reseeded, steps or self.warm_steps, "warm", t0,
            prev_params=prev_params,
        )

    def _absorb(self, vol, pts, cols, n_reseeded, steps, mode, t0, prev_params=None) -> TimestepReport:
        m = self.obs.metrics
        data = self._dataset(vol)
        p_before = self._eval_psnr(data)
        ttrain = now()
        loss, curve = self._fit(data, steps, psnr0=p_before)
        train_s = since(ttrain)
        rec = self.obs.trace
        if rec:
            rec.record(self._rid, "fit", ttrain, now(), t_index=self.t_index,
                       mode=mode, steps=steps)
        changed = None
        if prev_params is not None:
            # one host-side diff covers reseeded slots AND optimizer-moved
            # rows: everything the serving tier must treat as dirty
            changed = [int(i) for i in changed_indices(prev_params, self._host_params())]
        rep = TimestepReport(
            t_index=self.t_index,
            name=vol.name,
            mode=mode,
            steps=steps,
            n_extracted=int(pts.shape[0]),
            n_reseeded=int(n_reseeded),
            psnr_before=p_before,
            psnr_after=self._eval_psnr(data),
            loss_final=loss,
            wall_s=since(t0),
            train_s=train_s,
            n_traces=self.n_traces,
            psnr_curve=curve,
            changed_slots=changed,
        )
        # per-timestep telemetry: shard balance (the rebalancing trigger
        # signal), the step's analytic all-gather payload, and the device
        # memory watermark: Miranda-scale capacity limits show up here
        # timesteps before they run out of memory
        self.shard_balance()
        m.counter("train.gather_bytes").inc(
            all_gather_bytes_per_step(self.cfg, self.mesh, self.capacity) * steps
        )
        m.counter("train.timesteps").inc()
        m.histogram("train.timestep_wall_ms").observe(rep.wall_s * 1e3)
        devmem.record(m)
        self.reports.append(rep)
        self.t_index += 1
        if self.verbose:
            print(
                f"[insitu] t={rep.t_index} {rep.mode:4s} {rep.steps:4d} steps "
                f"PSNR {rep.psnr_before:5.2f}->{rep.psnr_after:5.2f} dB "
                f"reseed {rep.n_reseeded} ({rep.wall_s:.1f}s, traces={rep.n_traces})"
            )
        return rep

    def run(self, stream, *, store=None, server=None, serve_timestep=0) -> list[TimestepReport]:
        """Consume a ``VolumeStream``; optionally append each timestep's
        params to a ``TemporalCheckpointStore`` and/or push each timestep to
        a live ``RenderServer``.

        With the store's default asynchronous writer, ``append`` only copies
        the params to the host and enqueues the encode+write: delta
        quantization and compression overlap with the *next* timestep's
        training instead of stalling the stream. The store is flushed before
        returning, so every appended timestep is durable when ``run`` hands
        back its reports.

        ``server`` wires the live-viewing loop with **no caller-side row
        math**: after each timestep the model is re-registered on the
        server's ``serve_timestep`` timeline slot with this timestep's
        ``changed_slots``, so the server computes per-pose dirty tile rows
        itself from the changed Gaussians' projected bounds (cold start
        passes no ``changed`` and drops everything, which is vacuous on the
        first registration).

        On a mesh every rank calls ``run`` (each timestep gathers the full
        params, a collective); the store and the server are rank 0's.
        """
        out = []
        for vol in stream:
            rep = self.start(vol) if self.state is None else self.advance(vol)
            out.append(rep)
            rec = self.obs.trace
            # one device: the store copies the tensors out itself; a mesh
            # gathers the shards on every rank
            params = self.state.params if self.mesh is None else self._host_params()
            if store is not None:
                t0 = now() if rec else 0.0
                store.append(rep.t_index, params)
                if rec:
                    rec.record(self._rid, "ckpt", t0, now(), t_index=rep.t_index)
            if server is not None:
                t0 = now() if rec else 0.0
                host = G.to_numpy(params)
                if rep.changed_slots is None:
                    server.add_timestep(int(serve_timestep), host)
                else:
                    server.add_timestep(
                        int(serve_timestep), host,
                        changed=np.asarray(rep.changed_slots, np.int64),
                    )
                if rec:
                    rec.record(
                        self._rid, "serve", t0, now(), t_index=rep.t_index,
                        changed=(len(rep.changed_slots)
                                 if rep.changed_slots is not None else -1),
                    )
        if store is not None:
            store.flush()
        return out
