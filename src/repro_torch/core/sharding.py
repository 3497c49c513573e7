"""Distribution primitives for Grendel-style 3D-GS training over ranks
(PyTorch copy of the JAX package's ``core/sharding.py``).

Mapping, as in the JAX package:
  - Gaussians sharded over mesh axis ``model`` (Grendel: "each GPU holds a
    shard of the global point cloud and Gaussian parameters").
  - Training views sharded over mesh axis ``data``.
  - Within one view, horizontal pixel strips sharded over ``model``, so
    every rank owns both a Gaussian shard and a pixel block.

There is one process per rank and ``torch.distributed`` carries the
collectives: NCCL for CUDA tensors, gloo for CPU tensors. Communication per
step:
  all_gather(projected splats, model)   owner shard -> renderers
  reduce_scatter(splat grads, model)    renderers -> owner shard: the
                                        backward of the all_gather
  all_reduce(packed param grads, data)  the paper's fused all-reduce
  all_gather(strip halo rows, model)    distributed SSIM boundary exchange;
                                        its backward sends each halo's
                                        gradient back to the rows' owner

The loss sums are all-reduced forward and pass their gradient through
unchanged backward: every rank already holds dL/dS for the global sum S,
so the sharded gradients equal the one-device gradients. (The JAX package's
``psum`` transposes to another ``psum`` under ``check_vma=False``, which
scales its sharded gradients by data x model; ``ROADMAP.md`` queue C.)

The 11x11 window is applied as a depthwise convolution (``F.conv2d`` with
15 groups, one per statistic channel), VALID over the zero-padded strip, as
the JAX package leaves it to XLA's convolution. On the card the convolution
must not run in TF32 (cuDNN's default for float32): the train step turns it
off around its forward and backward.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.losses import gaussian_window

# the tensor-in, tensor-out collectives: newer torch names them
# all_gather_single / reduce_scatter_single and deprecates the old names
# (FutureWarning on every call); older releases have only the old names
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its size, this rank's index along
    it, and the process group of the ranks along it."""

    name: str
    size: int
    index: int
    group: object  # torch.distributed.ProcessGroup


class Mesh:
    """A (data, model) mesh over the ranks of the initialized process group.

    Rank r sits at (r // model, r % model), as ``jax.make_mesh`` lays the
    devices out. ``device`` is this rank's device: a CUDA device needs the
    NCCL backend and the CPU needs gloo, so no CUDA tensor is staged through
    the host. Every rank creates every subgroup, in the same order."""

    def __init__(self, n_data: int, n_model: int, device):
        if not dist.is_initialized():
            raise RuntimeError("Mesh: no process group; call torch.distributed.init_process_group first")
        world, rank = dist.get_world_size(), dist.get_rank()
        if n_data < 1 or n_model < 1 or world != n_data * n_model:
            raise ValueError(f"Mesh: a ({n_data}, {n_model}) mesh needs {n_data * n_model} ranks, "
                             f"the process group has {world}")
        self.device = torch.device(device)
        want = "nccl" if self.device.type == "cuda" else "gloo"
        if dist.get_backend() != want:
            raise ValueError(f"Mesh: {self.device} tensors need the {want} backend, "
                             f"the process group runs {dist.get_backend()}")
        self.rank = rank
        i, j = divmod(rank, n_model)
        data_group = model_group = None
        for jj in range(n_model):
            g = dist.new_group([ii * n_model + jj for ii in range(n_data)])
            if jj == j:
                data_group = g
        for ii in range(n_data):
            g = dist.new_group([ii * n_model + jj for jj in range(n_model)])
            if ii == i:
                model_group = g
        self.data = Axis("data", n_data, i, data_group)
        self.model = Axis("model", n_model, j, model_group)
        self.shape = {"data": n_data, "model": n_model}

    def barrier(self) -> None:
        """All ranks meet: a one-element all-reduce on this rank's device."""
        dist.all_reduce(torch.zeros(1, device=self.device))


def axis_size(axis: Axis | None) -> int:
    return 1 if axis is None else axis.size


def _check_axis(axis) -> None:
    if axis is not None and not isinstance(axis, Axis):
        raise TypeError(f"want a mesh axis (Mesh.data, Mesh.model) or None, got {axis!r}")


def gather_rows(x: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """Tiled all-gather along ``dim`` over ``axis`` (no autograd): rank k's
    block lands at [k*n, (k+1)*n) of ``dim``. The buffer holds the gathered
    axis outermost; a permute moves it to ``dim``."""
    x = x.contiguous()
    out = x.new_empty((axis.size * x.shape[0],) + tuple(x.shape[1:]))
    _all_gather_single(out, x, group=axis.group)
    if dim == 0:
        return out
    shape = list(x.shape)
    shape[dim] *= axis.size
    return out.reshape((axis.size,) + tuple(x.shape)).movedim(0, dim).reshape(shape)


def reduce_scatter_rows(x: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """Sum over ``axis`` and keep this rank's block of ``dim`` (no autograd):
    the transpose of :func:`gather_rows`."""
    shape = list(x.shape)
    shape[dim] //= axis.size
    blocks = x.reshape(shape[:dim] + [axis.size] + shape[dim:]).movedim(dim, 0).contiguous()
    out = x.new_empty(shape)
    _reduce_scatter_single(out, blocks.reshape((-1,) + tuple(shape[1:])), group=axis.group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return gather_rows(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_rows(g, ctx.axis, ctx.dim), None, None


def all_gather(x: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """Differentiable tiled all-gather along ``dim`` over ``axis``; its
    backward is the reduce-scatter (sum) over the same group."""
    return _AllGather.apply(x, axis, dim)


class _SumAcross(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        y = x.clone()
        for ax in axes:
            dist.all_reduce(y, group=ax.group)
        return y

    @staticmethod
    def backward(ctx, g):
        # every rank holds dL/dS of the global sum S already; summing it
        # again over the ranks would scale the gradient by their count
        return g, None


def sum_across(x: torch.Tensor, axes: tuple[Axis, ...]) -> torch.Tensor:
    """Sum over the ranks of ``axes`` forward; the incoming gradient passes
    through unchanged backward."""
    for ax in axes:
        _check_axis(ax)
    return _SumAcross.apply(x, tuple(axes)) if axes else x


def halo_exchange_rows(x: torch.Tensor, halo: int, axis: Axis | None, *, dim: int = 0) -> torch.Tensor:
    """Extend a row strip (rows along ``dim``) with ``halo`` rows from each
    neighbour along ``axis``.

    Workers at the image boundary receive zeros, which matches zero-padded
    SAME convolution on the full image. The boundary rows of every strip go
    through one all-gather; its backward (a reduce-scatter) sends each
    halo's gradient back to the rank whose rows it came from."""
    _check_axis(axis)
    n = axis_size(axis)
    if n == 1:
        pad = [0, 0] * (x.dim() - 1 - dim) + [halo, halo]
        return F.pad(x, pad)
    h = x.shape[dim]
    if h < halo:
        raise ValueError(f"a strip of {h} rows cannot lend {halo} halo rows")
    edges = torch.stack([x.narrow(dim, 0, halo), x.narrow(dim, h - halo, halo)])  # (2, ..., halo, ...)
    every = all_gather(edges, axis, 0).reshape((n, 2) + tuple(edges.shape[1:]))
    zeros = torch.zeros_like(edges[0])
    i = axis.index
    # worker i-1's bottom rows sit just above worker i's strip, worker i+1's
    # top rows just below it
    above = every[i - 1, 1] if i > 0 else zeros
    below = every[i + 1, 0] if i < n - 1 else zeros
    return torch.cat([above, x, below], dim=dim)


def _ssim_l1_sums_batched(pred: torch.Tensor, gt: torch.Tensor, window_size: int = 11,
                          strip_axis: Axis | None = None):
    """Per-view (ssim_map_sum, l1_sum) of (B, h, W, 3) strips, each (B,)."""
    halo = window_size // 2
    stack = torch.cat([pred, gt, pred * pred, gt * gt, pred * gt], dim=-1)  # (B,h,W,15)
    ext = halo_exchange_rows(stack, halo, strip_axis, dim=1)               # (B,h+2p,W,15)
    ext = F.pad(ext.permute(0, 3, 1, 2), (halo, halo))                     # (B,15,h+2p,W+2p): SAME columns
    w = gaussian_window(window_size, device=pred.device)
    y = F.conv2d(ext, w[None, None].expand(15, 1, window_size, window_size), groups=15)  # (B,15,h,W)
    mu0, mu1 = y[:, 0:3], y[:, 3:6]
    e00, e11, e01 = y[:, 6:9], y[:, 9:12], y[:, 12:15]
    s00 = e00 - mu0 * mu0
    s11 = e11 - mu1 * mu1
    s01 = e01 - mu0 * mu1
    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu0 * mu1 + c1) * (2 * s01 + c2)) / ((mu0 * mu0 + mu1 * mu1 + c1) * (s00 + s11 + c2))
    return ssim_map.sum(dim=(1, 2, 3)), torch.abs(pred - gt).sum(dim=(1, 2, 3))


def ssim_l1_sums(
    pred: torch.Tensor,  # (h, W, 3) local pixel strip
    gt: torch.Tensor,    # (h, W, 3)
    axis_name: Axis | None = None,
    *,
    window_size: int = 11,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Local (ssim_map_sum, l1_sum, pixel_count) for the distributed loss.

    With ``axis_name`` (the strip axis, ``Mesh.model``) the strip is extended
    with its neighbours' halo rows, so the sums over the axis equal
    single-device SAME-padded SSIM over the full image in exact arithmetic."""
    _check_axis(axis_name)
    ssim_s, l1_s = _ssim_l1_sums_batched(pred[None], gt[None], window_size, axis_name)
    return ssim_s[0], l1_s[0], torch.full((), float(pred.numel()), dtype=torch.float32, device=pred.device)


def distributed_gs_loss(
    pred: torch.Tensor,
    gt: torch.Tensor,
    *,
    lam: float = 0.2,
    strip_axis: Axis | None = None,
    reduce_axes: tuple[Axis, ...] = (),
) -> torch.Tensor:
    """(1-lam)*L1 + lam*D-SSIM over globally distributed pixels.

    ``pred``/``gt``: (B_local, h_local, W, 3). Returns the global scalar
    loss, the same on every rank: the (ssim, l1, count) sums go through one
    all-reduce per axis of ``reduce_axes``."""
    _check_axis(strip_axis)
    ssim_s, l1_s = _ssim_l1_sums_batched(pred, gt, strip_axis=strip_axis)
    cnt = torch.full((), float(pred.numel()), dtype=torch.float32, device=pred.device)
    sums = sum_across(torch.stack([ssim_s.sum(), l1_s.sum(), cnt]), tuple(reduce_axes))
    mean_ssim = sums[0] / sums[2]
    mean_l1 = sums[1] / sums[2]
    return (1.0 - lam) * mean_l1 + lam * (1.0 - mean_ssim) / 2.0
