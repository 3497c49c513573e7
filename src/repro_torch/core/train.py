"""3D-GS train step and eval renders (PyTorch, one device).

``make_train_step(cfg)`` returns the step: project -> depth sort -> bin ->
rasterize each view of the batch -> L1 + D-SSIM -> backward -> Adam with a
learning rate per field. On a CUDA device three hand-written kernels carry
it: the projection (its backward is the plain version's VJP, as in the JAX
package), the rasterizer forward and the rasterizer backward. On the CPU
the plain PyTorch versions run, and the CPU tests hold them to the JAX
package.

The JAX package runs the step under ``shard_map`` over a (data, model)
mesh. This is that step on a (1, 1) mesh with ``gather_mode="projected"``:
the all-gather of projected splats over the model axis and the psum of
gradients over the data axis are identities on one device, and there are
no pixel strips. Sharding over ranks comes with the port's multi-rank slice.

The serving stack renders through the eval factories: ``make_eval_render``
(one view), ``make_batched_eval_render`` (a batch of views, the serving hot
path) and ``make_tile_row_render`` (one tile row of one view, the
partial-render primitive of the tile cache).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import gaussians as G
from repro_torch.core import projection as P
from repro_torch.core import render as R
from repro_torch.core.config import GSConfig
from repro_torch.core.sharding import distributed_gs_loss
from repro_torch.optim.adam import AdamState, adam_init, adam_update
from repro_torch.optim.schedules import expon_lr, grendel_lr_scale


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


def shard_balance(state: GSTrainState, *, opacity_thresh: float = 0.005) -> dict:
    """Per-model-shard load statistics (one shard on one device): ``alive``
    counts Gaussians whose opacity clears ``opacity_thresh``, ``visible``
    slots that have ever projected on screen (``max_radii > 0``), and
    ``projected`` the accumulated per-view visibility tallies. ``imbalance``
    is max/mean of the per-shard alive counts (1.0 = balanced; 0.0 only for
    an all-dead model)."""
    logit_thresh = float(np.log(opacity_thresh / (1.0 - opacity_thresh)))
    capacity = [int(state.params.opacity_logit.shape[0])]
    alive = [int((state.params.opacity_logit > logit_thresh).sum())]
    visible = [int((state.max_radii > 0.0).sum())]
    projected = [float(state.vis_count.sum())]
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


def make_train_step(cfg: GSConfig):
    """Build the one-device train step.

    Returned fn: (state, cams: Camera batched (B, ...) on the host, gt:
    (B, H, W, 3) on the params' device) -> (state, {"loss": () tensor}).
    Nothing in it waits for the device: the caller reads the loss when it
    wants it."""
    if cfg.gather_mode not in ("auto", "projected"):
        raise NotImplementedError(f"gather_mode {cfg.gather_mode!r}: one device gathers nothing; "
                                  "sharding over ranks is not ported yet")
    bg = _DeviceBg(cfg.bg)
    scale = grendel_lr_scale(cfg.batch_size) if cfg.grendel_sqrt_lr_scaling else 1.0

    def loss_fn(p: G.GaussianModel, probe: torch.Tensor, cams: P.Camera, gt: torch.Tensor):
        imgs, radii = [], []
        for i in range(gt.shape[0]):
            packed = P.project(p, _view(cams, i))
            # the zero probe on the projected means: its gradient is the
            # view-space mean2d gradient that densification reads
            packed = packed + F.pad(probe[i], (0, P.PACKED_DIM - 2))
            radii.append(packed[:, P.RAD].detach())
            pk_sorted, _ = P.sort_by_depth(packed)
            img, _ = R.render_packed(
                pk_sorted,
                img_h=cfg.img_h,
                img_w=cfg.img_w,
                tile_h=cfg.tile_h,
                tile_w=cfg.tile_w,
                k_per_tile=cfg.k_per_tile,
                bg=bg.on(pk_sorted.device),
                binning=cfg.binning,
            )
            imgs.append(img)
        loss = distributed_gs_loss(torch.stack(imgs), gt, lam=cfg.lambda_dssim)
        return loss, torch.stack(radii)

    def step(state: GSTrainState, cams: P.Camera, gt: torch.Tensor):
        params = state.params
        leaves = [x.detach().requires_grad_() for x in params]
        probe = torch.zeros((gt.shape[0], params.n, 2), dtype=torch.float32, device=params.means.device,
                            requires_grad=True)
        with _NoTF32Conv():
            loss, radii = loss_fn(G.GaussianModel(*leaves), probe, cams, gt)
            *grads, probe_grad = torch.autograd.grad(loss, [*leaves, probe])

        grads = G.GaussianModel(*grads)
        # view-space positional gradient stats for densification
        g2d = torch.sqrt(torch.sum(probe_grad * probe_grad, dim=-1) + 1e-20).sum(dim=0)
        vis = (radii > 0.0).to(torch.float32).sum(dim=0)
        maxr = radii.amax(dim=0)

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


class _DeviceBg:
    """The config's background color as a tensor, made once per device, so a
    render never pays a host->device copy (which synchronizes the stream)."""

    def __init__(self, bg):
        self._bg = tuple(float(c) for c in bg)
        self._on: dict[torch.device, torch.Tensor] = {}

    def on(self, device: torch.device) -> torch.Tensor:
        t = self._on.get(device)
        if t is None:
            t = self._on[device] = torch.tensor(self._bg, dtype=torch.float32, device=device)
        return t


def _project_sorted(params: G.GaussianModel, cam: P.Camera) -> torch.Tensor:
    packed = P.project(params, cam)
    pk_sorted, _ = P.sort_by_depth(packed)
    return pk_sorted


def _view(cams: P.Camera, i: int) -> P.Camera:
    return P.Camera(*[x[i] for x in cams])


def make_eval_render(cfg: GSConfig):
    """Eval render of one view: fn(params, cam) -> (image (H,W,3), T (H,W))."""
    bg = _DeviceBg(cfg.bg)

    def fn(params: G.GaussianModel, cam: P.Camera):
        pk_sorted = _project_sorted(params, cam)
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


def make_tile_row_render(cfg: GSConfig, *, row: int):
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
    """
    bg = _DeviceBg(cfg.bg)
    row = int(row)
    row_offset = row * cfg.tile_h

    def fn(params: G.GaussianModel, cam: P.Camera) -> torch.Tensor:
        pk_sorted = _project_sorted(params, cam)
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


def make_batched_eval_render(cfg: GSConfig):
    """Eval render of a BATCH of views (the serving hot path).

    Returned fn: (params, cams: Camera with a leading batch dim B) ->
    (B, H, W, 3) images on the params' device. The views run one after the
    other (the JAX package's "map" mode): one view's working set at a time.
    On a CUDA device every launch is asynchronous, so the call returns while
    the batch still renders; the caller decides when to wait.
    """
    one = make_eval_render(cfg)

    def fn(params: G.GaussianModel, cams: P.Camera) -> torch.Tensor:
        b = int(cams.fx.shape[0])
        return torch.stack([one(params, _view(cams, i))[0] for i in range(b)])

    return fn
