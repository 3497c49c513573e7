"""3D-GS train step and eval renders (PyTorch), on one device or across
ranks.

``make_train_step(cfg, mesh)`` returns the step: project -> gather over the
model axis -> depth sort -> bin -> rasterize each view (or each view's pixel
strip) -> L1 + D-SSIM over the mesh -> backward (the gather's backward is a
reduce-scatter) -> the fused all-reduce of the packed gradients over the
data axis -> Adam with a learning rate per field on the own shard. It is
the JAX package's ``shard_map`` step, with one process per rank and
``torch.distributed`` collectives (``core/sharding.py``). With no mesh the
collectives are identities and there are no strips: the one-device step.
The paper's replicated baseline is the same code on a mesh with model=1.
Under a traced ``GSTrainer.fit`` each stage records a span, and under
``torch.profiler`` a ``gs.<stage>`` range (``obs/steptrace.py``).

On a CUDA device three hand-written kernels carry it: the projection (its
backward is the plain version's VJP, as in the JAX package), the rasterizer
forward and the rasterizer backward. On the CPU the plain PyTorch versions
run, and the CPU tests hold them to the JAX package.

The serving stack renders through the eval factories, on one device or
across ranks: ``make_eval_render`` (one view), ``make_batched_eval_render``
(a batch of views, the serving hot path; its views split over the data
axis) and ``make_tile_row_render`` (one tile row of one view, the
partial-render primitive of the tile cache).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core import gaussians as G
from repro_torch.core import projection as P
from repro_torch.core import render as R
from repro_torch.core.config import GSConfig
from repro_torch.core.sharding import Mesh, all_gather, distributed_gs_loss, gather_rows, reduce_scatter_rows
from repro_torch.obs import steptrace
from repro_torch.optim.adam import AdamState, adam_init, adam_update
from repro_torch.optim.schedules import expon_lr, grendel_lr_scale
from repro_torch.utils.tree import pack_pytree


class GSTrainState(NamedTuple):
    params: G.GaussianModel
    adam: AdamState
    step: torch.Tensor          # () int32
    # densification statistics, per Gaussian
    grad2d_accum: torch.Tensor  # (n,) sum of view-space grad norms
    vis_count: torch.Tensor     # (n,) number of views seen in
    max_radii: torch.Tensor     # (n,) max screen-space radius


def init_state(params: G.GaussianModel) -> GSTrainState:
    n, dev = params.n, params.means.device
    return GSTrainState(
        params=params,
        adam=adam_init(params),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        grad2d_accum=torch.zeros((n,), dtype=torch.float32, device=dev),
        vis_count=torch.zeros((n,), dtype=torch.float32, device=dev),
        max_radii=torch.zeros((n,), dtype=torch.float32, device=dev),
    )


def state_from_numpy(state, device) -> GSTrainState:
    """The port's train state from anything with ``GSTrainState``'s fields
    holding array-likes: the JAX package's state after
    ``jax.tree_util.tree_map(np.asarray, state)``, or :func:`state_to_numpy`'s
    output. Params, Adam moments and count, step and the densify statistics
    all carry over, so both packages can go on from the same state."""
    def t(x, dtype=torch.float32):
        return torch.tensor(np.asarray(x)).to(device=device, dtype=dtype).contiguous()

    def model(m):
        return G.GaussianModel(*[t(getattr(m, f)) for f in G.GaussianModel._fields])

    return GSTrainState(
        params=model(state.params),
        adam=AdamState(model(state.adam.m), model(state.adam.v), t(state.adam.count, torch.int32)),
        step=t(state.step, torch.int32),
        grad2d_accum=t(state.grad2d_accum),
        vis_count=t(state.vis_count),
        max_radii=t(state.max_radii),
    )


def state_to_numpy(state: GSTrainState) -> GSTrainState:
    """Host copy of a train state with numpy leaves (float32; int32 counts)."""
    def n(x):
        return x.detach().cpu().numpy()

    def model(m):
        return G.GaussianModel(*[n(x) for x in m])

    return GSTrainState(
        params=model(state.params),
        adam=AdamState(model(state.adam.m), model(state.adam.v), n(state.adam.count)),
        step=n(state.step),
        grad2d_accum=n(state.grad2d_accum),
        vis_count=n(state.vis_count),
        max_radii=n(state.max_radii),
    )


def _map_rows(state: GSTrainState, fn) -> GSTrainState:
    """Apply ``fn`` to every per-Gaussian leaf (params, Adam moments, densify
    statistics); the step and the Adam count are replicated and stay."""
    def model(mm):
        return G.GaussianModel(*[fn(x) for x in mm])

    return GSTrainState(
        params=model(state.params),
        adam=AdamState(model(state.adam.m), model(state.adam.v), state.adam.count),
        step=state.step,
        grad2d_accum=fn(state.grad2d_accum),
        vis_count=fn(state.vis_count),
        max_radii=fn(state.max_radii),
    )


def shard_state(state: GSTrainState, mesh: Mesh) -> GSTrainState:
    """This rank's model shard of a full state: contiguous row blocks, rank
    j of the model axis holding rows [j*n/m, (j+1)*n/m) (``PS("model")`` in
    the JAX package's ``state_shardings``). Data replicas hold the same
    shard."""
    m, j = mesh.model.size, mesh.model.index
    n = state.params.n
    if n % m:
        raise ValueError(f"{n} Gaussians do not split into {m} equal shards")
    k = n // m
    return _map_rows(state, lambda x: x[j * k:(j + 1) * k].clone())


def _row_leaves(state: GSTrainState) -> list[torch.Tensor]:
    return [*state.params, *state.adam.m, *state.adam.v, state.grad2d_accum, state.vis_count, state.max_radii]


def gather_state(state: GSTrainState, mesh: Mesh) -> GSTrainState:
    """The full state on every rank, from each rank's model shard: the
    per-Gaussian leaves cross the model axis as one (n_local, F) float32
    all-gather (a collective: every rank of the mesh calls it)."""
    rows = _row_leaves(state)
    k = state.params.n
    full = gather_rows(torch.cat([x.reshape(k, -1).to(torch.float32) for x in rows], dim=1), mesh.model)
    cols = torch.split(full, [x[:1].numel() for x in rows], dim=1)
    it = iter(c.reshape((full.shape[0],) + tuple(x.shape[1:])).to(x.dtype).contiguous() for c, x in zip(cols, rows))
    return _map_rows(state, lambda _: next(it))


def resolve_gather_mode(cfg: GSConfig, mesh) -> str:
    """The comm schedule ``make_train_step`` will actually use (resolves
    ``"auto"`` exactly like the step builder does). ``mesh`` is anything
    with a ``shape`` dict holding the ``"data"`` and ``"model"`` sizes;
    None is one device."""
    d, m = (mesh.shape["data"], mesh.shape["model"]) if mesh is not None else (1, 1)
    mode = cfg.gather_mode
    if mode == "auto":
        mode = "params3d" if (cfg.batch_size // d) >= 2 and m > 1 else "projected"
    if mode not in ("projected", "params3d"):
        raise ValueError(f"unknown gather_mode {cfg.gather_mode!r}")
    return mode


def all_gather_bytes_per_step(cfg: GSConfig, mesh, n_total: int) -> int:
    """Analytic model-axis all-gather payload one train step materializes per
    rank (bytes of the gathered tensors; float32): ``projected`` gathers
    11-float splats per local view, ``params3d`` the 3D state once per
    step. Computed from the shapes, not measured."""
    d, m = (mesh.shape["data"], mesh.shape["model"]) if mesh is not None else (1, 1)
    if m <= 1:
        return 0
    if resolve_gather_mode(cfg, mesh) == "params3d":
        sh_k = (cfg.sh_degree + 1) ** 2
        floats = n_total * (11 + 3 * sh_k)
    else:
        b_local = max(cfg.batch_size // d, 1)
        floats = b_local * n_total * P.PACKED_DIM
    return int(floats) * 4


def shard_balance(state: GSTrainState, mesh: Mesh | None = None, *, opacity_thresh: float = 0.005) -> dict:
    """Per-model-shard load statistics, the trigger signal for dynamic
    rebalancing (Grendel's result: static Gaussian splits skew).

    Each rank reduces its own shard on its device, and the per-shard scalars
    cross the model axis in one small all-gather (a collective: every rank
    of the mesh calls it). ``alive`` counts Gaussians whose opacity clears
    ``opacity_thresh``, ``visible`` slots that have ever projected on screen
    (``max_radii > 0``), and ``projected`` the accumulated per-view
    visibility tallies. ``imbalance`` is max/mean of the per-shard alive
    counts (1.0 = balanced; 0.0 only for an all-dead model)."""
    logit_thresh = float(np.log(opacity_thresh / (1.0 - opacity_thresh)))
    mine = torch.stack([
        torch.full((), state.params.opacity_logit.shape[0], dtype=torch.float64, device=state.step.device),
        (state.params.opacity_logit > logit_thresh).sum().to(torch.float64),
        (state.max_radii > 0.0).sum().to(torch.float64),
        state.vis_count.sum().to(torch.float64),  # the float32 sum, exactly
    ])
    per_shard = (gather_rows(mine[None], mesh.model) if mesh is not None else mine[None]).cpu().tolist()
    capacity = [int(r[0]) for r in per_shard]
    alive = [int(r[1]) for r in per_shard]
    visible = [int(r[2]) for r in per_shard]
    projected = [float(r[3]) for r in per_shard]
    mean_alive = sum(alive) / len(alive)
    imbalance = (max(alive) / mean_alive) if mean_alive > 0 else 0.0
    return {
        "n_shards": len(capacity),
        "capacity": capacity,
        "alive": alive,
        "visible": visible,
        "projected": projected,
        "alive_total": sum(alive),
        "imbalance": imbalance,
    }


def record_shard_balance(metrics, bal: dict, *, prefix: str = "train") -> None:  # analysis: declare(train.shard_capacity.s*, train.shard_alive.s*, train.shard_visible.s*, train.shard_projected.s*, train.alive_total, train.shard_imbalance)
    """Land a :func:`shard_balance` result on a registry: per-shard gauges
    ``<prefix>.shard_alive.s<i>`` / ``.shard_visible.s<i>`` /
    ``.shard_projected.s<i>`` / ``.shard_capacity.s<i>`` plus the
    ``<prefix>.shard_imbalance`` gauge a rebalancing pass will trigger on."""
    for i in range(bal["n_shards"]):
        metrics.gauge(f"{prefix}.shard_capacity.s{i}").set(bal["capacity"][i])
        metrics.gauge(f"{prefix}.shard_alive.s{i}").set(bal["alive"][i])
        metrics.gauge(f"{prefix}.shard_visible.s{i}").set(bal["visible"][i])
        metrics.gauge(f"{prefix}.shard_projected.s{i}").set(bal["projected"][i])
    metrics.gauge(f"{prefix}.alive_total").set(bal["alive_total"])
    metrics.gauge(f"{prefix}.shard_imbalance").set(round(float(bal["imbalance"]), 6))


class _NoTF32Conv:
    """cuDNN runs float32 convolutions in TF32 by default (three decimal
    digits); the SSIM window must not, in its forward or its backward."""

    def __enter__(self):
        self._prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32 = self._prev


def make_train_step(cfg: GSConfig, mesh: Mesh | None = None):
    """Build the train step, on one device (``mesh=None``) or on this rank
    of a (data, model) mesh.

    Returned fn: (state, cams: Camera batched (B, ...) on the host, gt:
    (B, H, W, 3) on the params' device) -> (state, {"loss": () tensor}).
    On a mesh, ``state`` is this rank's model shard (:func:`shard_state`)
    and ``cams``/``gt`` the global batch: data rank i takes views
    [i*B/d, (i+1)*B/d), and with pixel strips (``cfg.pixel_parallel`` and
    model > 1) model rank j renders and scores rows [j*H/m, (j+1)*H/m) of
    them. The gradients, ``grad2d_accum``, ``vis_count`` and ``max_radii``
    equal the one-device step's, and the loss is the same on every rank.
    Nothing in it waits for the device: the caller reads the loss when it
    wants it."""
    d = mesh.data.size if mesh is not None else 1
    m = mesh.model.size if mesh is not None else 1
    strip = cfg.pixel_parallel and m > 1
    if strip and cfg.img_h % (m * cfg.tile_h):
        raise ValueError(f"img_h {cfg.img_h} must split into {m} model-axis strips of whole {cfg.tile_h}-row tiles")
    if cfg.batch_size % d:
        raise ValueError(f"global batch {cfg.batch_size} must divide over {d} data ranks")
    strip_h = cfg.img_h // m if strip else cfg.img_h
    b_local = cfg.batch_size // d
    i_data = mesh.data.index if mesh is not None else 0
    j_model = mesh.model.index if mesh is not None else 0
    # one device gathers nothing: every mode is the projected step there
    params3d = mesh is not None and resolve_gather_mode(cfg, mesh) == "params3d"
    bg = _OnDevice(cfg.bg)
    scale = grendel_lr_scale(cfg.batch_size) if cfg.grendel_sqrt_lr_scaling else 1.0
    if mesh is None:
        reduce_axes = ()
    else:
        def gather(x):
            return all_gather(x, mesh.model)
        reduce_axes = (mesh.data, mesh.model)
    strip_axis = mesh.model if strip else None
    # strip j renders its rows with the splats moved up by its first row
    my_shift = _OnDevice([float(j_model * strip_h) if k == P.MY else 0.0 for k in range(P.PACKED_DIM)])

    def loss_fn(p: G.GaussianModel, probe: torch.Tensor, cams: P.Camera, gt: torch.Tensor, tc):
        n_local = p.n
        if params3d:
            # the 3D state crosses the model axis once per step (14 + 3K
            # floats per Gaussian); every rank projects all N per view
            with steptrace.record(tc, "gather"):
                flat3d = torch.cat([p.means, p.log_scales, p.quats, p.opacity_logit[:, None],
                                    p.sh.reshape(n_local, -1)], dim=1)
                flat_all = gather(flat3d)
                p_full = G.GaussianModel(
                    means=flat_all[:, 0:3].contiguous(),
                    log_scales=flat_all[:, 3:6].contiguous(),
                    quats=flat_all[:, 6:10].contiguous(),
                    opacity_logit=flat_all[:, 10].contiguous(),
                    sh=flat_all[:, 11:].reshape(flat_all.shape[0], p.sh.shape[1], 3).contiguous(),
                )
        imgs, radii = [], []
        # one view at a time, each view's splats gathered alone: the step
        # never holds a (B, N, 11) copy of the batch's splats
        for i in range(gt.shape[0]):
            if tc:
                tc.view = i  # the Functions of this view pin it for their backward
            if params3d:
                # the zero probe on the projected means: its gradient is
                # the view-space mean2d gradient that densification reads
                with steptrace.record(tc, "project", i):
                    gathered = P.project(p_full, _view(cams, i)) + F.pad(probe[i], (0, P.PACKED_DIM - 2))
                    radii.append(gathered[j_model * n_local:(j_model + 1) * n_local, P.RAD].detach())
                    if strip:
                        gathered = gathered - my_shift.on(gathered.device)
            else:
                # Grendel: project the own shard, gather the 11-float splats
                with steptrace.record(tc, "project", i):
                    packed = P.project(p, _view(cams, i)) + F.pad(probe[i], (0, P.PACKED_DIM - 2))
                    radii.append(packed[:, P.RAD].detach())
                if mesh is None:
                    gathered = packed
                else:
                    with steptrace.record(tc, "gather", i):
                        gathered = gather(packed)                                        # (N, 11)
                        if strip:
                            gathered = gathered - my_shift.on(gathered.device)
            with steptrace.record(tc, "sort", i):
                pk_sorted, _ = P.sort_by_depth(gathered)
            with steptrace.record(tc, "bin", i):
                idx, valid = R.bin_tiles(pk_sorted, img_h=strip_h, img_w=cfg.img_w, tile_h=cfg.tile_h,
                                         tile_w=cfg.tile_w, k_per_tile=cfg.k_per_tile, binning=cfg.binning)
            with steptrace.record(tc, "raster", i):
                img, _ = R.raster_ops.rasterize_tiles(pk_sorted, idx, valid, img_h=strip_h, img_w=cfg.img_w,
                                                      tile_h=cfg.tile_h, tile_w=cfg.tile_w,
                                                      bg=bg.on(pk_sorted.device))
            del idx, valid  # freed here, as inside render_packed, so the next view's peak is the same
            imgs.append(img)
        with steptrace.record(tc, "loss"):
            loss = distributed_gs_loss(torch.stack(imgs), gt, lam=cfg.lambda_dssim, strip_axis=strip_axis,
                                       reduce_axes=reduce_axes)
            radii = torch.stack(radii)
        return loss, radii

    def step(state: GSTrainState, cams: P.Camera, gt: torch.Tensor):
        if mesh is not None:
            views = slice(i_data * b_local, (i_data + 1) * b_local)
            cams = P.Camera(*[x[views] for x in cams])
            gt = gt[views]
            if strip:
                gt = gt[:, j_model * strip_h:(j_model + 1) * strip_h]
        params = state.params
        leaves = [x.detach().requires_grad_() for x in params]
        probe = torch.zeros((gt.shape[0], params.n * (m if params3d else 1), 2), dtype=torch.float32,
                            device=params.means.device, requires_grad=True)
        tc = steptrace.current()  # set by a traced GSTrainer.fit on this thread
        with _NoTF32Conv():
            loss, radii = loss_fn(G.GaussianModel(*leaves), probe, cams, gt, tc)
            with steptrace.record(tc, "backward"):
                *grads, probe_grad = torch.autograd.grad(loss, [*leaves, probe])
                grads = G.GaussianModel(*grads)
                if params3d and mesh is not None:
                    # every strip's share of the view-space gradient of the own shard
                    probe_grad = reduce_scatter_rows(probe_grad, mesh.model, dim=1)
                # view-space positional gradient stats for densification
                g2d = torch.sqrt(torch.sum(probe_grad * probe_grad, dim=-1) + 1e-20).sum(dim=0)
                vis = (radii > 0.0).to(torch.float32).sum(dim=0)
                maxr = radii.amax(dim=0)
        if mesh is not None:
            with steptrace.record(tc, "reduce"):
                # the paper's fused all-reduce: ONE collective over packed grads
                flat, unpack = pack_pytree(grads)
                dist.all_reduce(flat, group=mesh.data.group)
                grads = unpack(flat)
                stats = torch.stack([g2d, vis])
                dist.all_reduce(stats, group=mesh.data.group)
                g2d, vis = stats[0], stats[1]
                dist.all_reduce(maxr, op=dist.ReduceOp.MAX, group=mesh.data.group)

        with steptrace.record(tc, "adam"):
            # Adam with per-field LRs (Grendel sqrt-batch scaling)
            lr_means = expon_lr(state.step, lr_init=cfg.lr_means_init, lr_final=cfg.lr_means_final,
                                max_steps=cfg.max_steps)
            lrs = G.GaussianModel(
                means=lr_means * scale,
                log_scales=cfg.lr_scales * scale,
                quats=cfg.lr_quats * scale,
                opacity_logit=cfg.lr_opacity * scale,
                sh=cfg.lr_sh * scale,
            )
            new_params, new_adam = adam_update(grads, state.adam, params, lrs)
            new_state = GSTrainState(
                params=new_params,
                adam=new_adam,
                step=state.step + 1,
                grad2d_accum=state.grad2d_accum + g2d,
                vis_count=state.vis_count + vis,
                max_radii=torch.maximum(state.max_radii, maxr),
            )
        return new_state, {"loss": loss.detach()}

    return step


class _OnDevice:
    """A constant vector (the config's background color, a strip's splat
    shift) as a tensor, made once per device, so a render never pays a
    host->device copy (which synchronizes the stream)."""

    def __init__(self, values):
        self._bg = tuple(float(c) for c in values)
        self._on: dict[torch.device, torch.Tensor] = {}

    def on(self, device: torch.device) -> torch.Tensor:
        t = self._on.get(device)
        if t is None:
            t = self._on[device] = torch.tensor(self._bg, dtype=torch.float32, device=device)
        return t


def _view(cams: P.Camera, i: int) -> P.Camera:
    return P.Camera(*[x[i] for x in cams])


def make_eval_render(cfg: GSConfig, mesh: Mesh | None = None):
    """Eval render of one view: fn(params, cam) -> (image (H,W,3), T (H,W)).
    On a mesh, ``params`` is this rank's model shard: each rank projects its
    shard, the splats cross the model axis in one all-gather, and every
    rank renders the full frame."""
    bg = _OnDevice(cfg.bg)

    def fn(params: G.GaussianModel, cam: P.Camera):
        packed = P.project(params, cam)
        if mesh is not None:
            packed = gather_rows(packed, mesh.model)
        pk_sorted, _ = P.sort_by_depth(packed)
        return R.render_packed(
            pk_sorted,
            img_h=cfg.img_h,
            img_w=cfg.img_w,
            tile_h=cfg.tile_h,
            tile_w=cfg.tile_w,
            k_per_tile=cfg.k_per_tile,
            bg=bg.on(pk_sorted.device),
            binning=cfg.binning,
        )

    return fn


def make_tile_row_render(cfg: GSConfig, *, row: int, mesh: Mesh | None = None):
    """Eval render of ONE horizontal tile row of one view.

    Returned fn: (params, a single Camera) -> (cfg.tile_h, cfg.img_w, 3)
    image — the pixel rows ``[row*tile_h, (row+1)*tile_h)`` of the full-frame
    render, **bit-identical** to the same rows of
    :func:`make_batched_eval_render`'s output. The project -> depth-sort
    prefix is the full-frame computation verbatim; the row's tile lists are
    the full frame's lists for that row (``render.bin_tile_row``, which
    reproduces the full frame's superblock geometry when it bins
    hierarchically), and the compositor sees the same per-tile inputs and
    pixel coordinates through ``row_offset``. The serving tile cache rests
    on this: a cache that already holds most of a frame's tiles re-renders
    only the missing rows.

    On a mesh, ``params`` is this rank's model shard: the projected shards
    cross the model axis in one all-gather before the sort, and every data
    row computes the same strip (the camera is replicated, as the JAX
    package's ``in_specs`` replicate it). Unlike the JAX package, which bins
    strips flat, the strip keeps the frame's superblock geometry, so it
    stays bitwise equal to its frame's rows on every mesh.
    """
    bg = _OnDevice(cfg.bg)
    row = int(row)
    row_offset = row * cfg.tile_h

    def fn(params: G.GaussianModel, cam: P.Camera) -> torch.Tensor:
        packed = P.project(params, cam)
        if mesh is not None:
            packed = gather_rows(packed, mesh.model)
        pk_sorted, _ = P.sort_by_depth(packed)
        idx, valid = R.bin_tile_row(
            pk_sorted,
            row=row,
            img_h=cfg.img_h,
            img_w=cfg.img_w,
            tile_h=cfg.tile_h,
            tile_w=cfg.tile_w,
            k_per_tile=cfg.k_per_tile,
            binning=cfg.binning,
        )
        img, _ = R.raster_ops.rasterize_tiles(
            pk_sorted, idx, valid,
            img_h=cfg.tile_h, img_w=cfg.img_w, tile_h=cfg.tile_h, tile_w=cfg.tile_w,
            bg=bg.on(pk_sorted.device), row_offset=row_offset,
        )
        return img

    return fn


def make_batched_eval_render(cfg: GSConfig, mesh: Mesh | None = None):
    """Eval render of a BATCH of views (the serving hot path).

    Returned fn: (params, cams: Camera with a leading batch dim B) ->
    (B, H, W, 3) images on the params' device. The views run one after the
    other (the JAX package's "map" mode): one view's working set at a time.
    On a CUDA device every launch is asynchronous, so the call returns while
    the batch still renders; the caller decides when to wait.

    On a (data, model) mesh every rank gets all B cameras and ``params`` is
    its model shard. The rank at data index i renders views
    ``[i*B/d, (i+1)*B/d)`` (each through :func:`make_eval_render`'s model
    gather), and the images cross the data axis in one all-gather, so every
    rank returns the B images in batch order. B must divide by d.
    """
    one = make_eval_render(cfg, mesh)

    def fn(params: G.GaussianModel, cams: P.Camera) -> torch.Tensor:
        b = int(cams.fx.shape[0])
        if mesh is None:
            return torch.stack([one(params, _view(cams, i))[0] for i in range(b)])
        d = mesh.data.size
        if b % d:
            raise ValueError(f"a batch of {b} views does not split over {d} data ranks")
        k, i = b // d, mesh.data.index
        local = torch.stack([one(params, _view(cams, i * k + v))[0] for v in range(k)])
        return gather_rows(local, mesh.data)

    return fn
