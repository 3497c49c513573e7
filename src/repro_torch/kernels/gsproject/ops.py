"""Wrapper of the projection kernel: input checks, dispatch by device.

``project_packed(g, cam)`` returns the (N, 11) packed splats. A model on the
CPU runs the plain version (``ref.project_ref``); a model on a CUDA device
runs ``gsproject.cu`` on the model's own tensors, with the camera passed as a
32-float launch argument laid out as the JAX wrapper lays it out. The kernel
writes (N, 11) itself: there is no padding, transpose or copy per view. It
covers SH degrees 0-3 (1, 4, 9 or 16 coefficients per channel, the range of
``core/gaussians.py`` ``eval_sh``); a CUDA model above degree 3 raises
``NotImplementedError`` naming its degree rather than falling back. On the
CPU the plain version keeps ``eval_sh``'s behaviour, as the JAX oracle does.

On both devices the projection is a ``torch.autograd.Function``. On CUDA
its backward is ``gsproject.cu``'s backward kernel, one launch a view that
writes the five parameter gradients from the saved parameters, the
forward's camera vector and the (N, 11) splat gradients. On the CPU it is
the vector-Jacobian product of ``project_ref``, recomputed from the saved
inputs, as the JAX package's wrapper does with its oracle; no autograd
graph of the plain version is kept between forward and backward. Each
direction of ``Project`` opens one operation-counter region
(``kernels/cost.py`` ``region``) around its choice of device and reports
the kernel's formula from it, so a step counts the same on either device.
``launch`` and ``launch_bwd`` only check, allocate and launch.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from repro_torch.core import gaussians as G
from repro_torch.kernels import _lib
from repro_torch.kernels import cost as _cost
from repro_torch.kernels.gsproject.ref import project_ref
from repro_torch.obs import steptrace

CAM_SLOTS = 32  # viewmat(16), fx, fy, cx, cy, near, campos(3) -> padded to 32
SH_COEFFS = (1, 4, 9, 16)  # per channel, SH degrees 0-3: the kernel's instantiations

launch_count = _lib.launches("gsproject_fwd")
bwd_launch_count = _lib.launches("gsproject_bwd")


def cam_vector(cam, near: float = 0.01) -> np.ndarray:
    """The kernel's camera argument: float32 (32,), laid out as the JAX
    wrapper lays it out (viewmat row-major, fx, fy, cx, cy, near, campos)."""
    vm = np.asarray(torch.as_tensor(cam.viewmat).detach().cpu(), np.float32).reshape(4, 4)
    # The SH color's camera position, -R^T t, in float32 on the host. The
    # plain version forms it on the device (a 3x3 product whose summation
    # order is the BLAS's); the two differ by at most an ulp of each
    # coordinate, which moves the normalized directions and the colors by
    # ~1e-7, far inside the kernel's 2e-5 tolerance, and keeps the camera a
    # by-value launch argument with no device read.
    campos = -vm[:3, :3].T @ vm[:3, 3]
    vec = np.zeros((CAM_SLOTS,), np.float32)
    vec[:16] = vm.reshape(-1)
    vec[16:20] = [float(torch.as_tensor(v)) for v in (cam.fx, cam.fy, cam.cx, cam.cy)]
    vec[20] = near
    vec[21:24] = campos
    return vec


def _check_model(g, cam_vec: np.ndarray) -> np.ndarray:
    """Check a CUDA model's five tensors and the camera vector; returns the
    camera as contiguous float32."""
    dev = g.means.device
    if dev.type != "cuda":
        raise ValueError(f"gsproject kernel needs CUDA tensors, got {dev}")
    n = g.means.shape[0]
    for name, x, shape in (("means", g.means, (n, 3)), ("log_scales", g.log_scales, (n, 3)),
                           ("quats", g.quats, (n, 4)), ("opacity_logit", g.opacity_logit, (n,)),
                           ("sh", g.sh, (n, g.sh.shape[1], 3))):
        _lib.check_tensor(name, x, shape, dev)
    cam = np.ascontiguousarray(cam_vec, np.float32)
    if cam.shape != (CAM_SLOTS,):
        raise ValueError(f"camera vector must be ({CAM_SLOTS},), got {cam.shape}")
    return cam


def launch(g, cam_vec: np.ndarray, *, blur: float = 0.3) -> torch.Tensor:
    """Run ``gsproject.cu`` on a CUDA model; returns the (N, 11) packed splats."""
    cam = _check_model(g, cam_vec)
    dev, n = g.means.device, g.means.shape[0]
    out = torch.empty((n, 11), dtype=torch.float32, device=dev)
    _lib.call("gsproject_fwd", dev, g.means.data_ptr(), g.log_scales.data_ptr(), g.quats.data_ptr(),
              g.opacity_logit.data_ptr(), g.sh.data_ptr(), 3 * g.sh.shape[1], cam.ctypes.data, out.data_ptr(), n,
              blur)
    return out


def launch_bwd(g, cam_vec: np.ndarray, gpacked: torch.Tensor, *, blur: float = 0.3) -> tuple:
    """Run ``gsproject.cu``'s backward on a CUDA model and the (N, 11)
    gradient of its packed splats; returns the gradients of means,
    log-scales, quats, opacity logit and SH, shaped as the model."""
    cam = _check_model(g, cam_vec)
    dev, n = g.means.device, g.means.shape[0]
    gpacked = gpacked.contiguous()
    _lib.check_tensor("gpacked", gpacked, (n, 11), dev)
    grads = tuple(torch.empty(x.shape, dtype=torch.float32, device=dev) for x in g)
    _lib.call("gsproject_bwd", dev, g.means.data_ptr(), g.log_scales.data_ptr(), g.quats.data_ptr(),
              g.opacity_logit.data_ptr(), g.sh.data_ptr(), 3 * g.sh.shape[1], cam.ctypes.data, gpacked.data_ptr(),
              *(x.data_ptr() for x in grads), n, blur)
    return grads


class Project(torch.autograd.Function):
    """The projection kernel (CUDA) or plain version (CPU) forward; the
    backward kernel (CUDA) or the plain version's VJP (CPU) backward."""

    @staticmethod
    def forward(ctx, means, log_scales, quats, opacity_logit, sh, cam, near: float, blur: float, max_radius: float):
        ctx.near, ctx.blur, ctx.max_radius = near, blur, max_radius
        ctx.trace = steptrace.pin()  # the backward's span joins this step's tree
        ctx.save_for_backward(means, log_scales, quats, opacity_logit, sh)
        g = G.GaussianModel(means, log_scales, quats, opacity_logit, sh)
        cuda = means.device.type == "cuda"
        ctx.cam = cam_vector(cam, near) if cuda else cam  # on CUDA the backward kernel's camera argument too
        with _cost.region("gsproject") as r:
            out = launch(g, ctx.cam, blur=blur) if cuda else project_ref(g, cam, near=near, blur=blur,
                                                                         max_radius=max_radius)
            if r:
                r.report(*_cost.gsproject_cost(g.n, sh.shape[1]), out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, gpacked):
        tc, view = ctx.trace
        with steptrace.record(tc, "vjp", view), _cost.region("gsproject_bwd") as r:
            g = G.GaussianModel(*ctx.saved_tensors)
            if gpacked.device.type == "cuda":
                grads = launch_bwd(g, ctx.cam, gpacked, blur=ctx.blur)
            else:
                leaves = [x.detach().requires_grad_() for x in g]
                with torch.enable_grad():
                    packed = project_ref(G.GaussianModel(*leaves), ctx.cam, near=ctx.near, blur=ctx.blur,
                                         max_radius=ctx.max_radius)
                    grads = torch.autograd.grad(packed, leaves, gpacked)
            if r:
                r.report(*_cost.gsproject_bwd_cost(g.n, g.sh.shape[1]), *grads)
        return (*grads, None, None, None, None)


def project_packed(g, cam, *, near: float = 0.01, blur: float = 0.3, max_radius: float = 1e4) -> torch.Tensor:
    """(N, 11) packed splats: the plain version on CPU, the kernel on CUDA."""
    if g.means.device.type == "cuda":
        if g.sh.shape[1] not in SH_COEFFS:
            raise NotImplementedError(
                f"the CUDA projection kernel covers SH degrees 0-3; this model has SH degree {g.sh_degree} "
                f"({g.sh.shape[1]} coefficients per channel)"
            )
        if max_radius != 1e4:
            raise NotImplementedError("the CUDA projection kernel clamps the radius at 1e4")
    return Project.apply(*g, cam, near, blur, max_radius)
