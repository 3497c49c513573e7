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

On both devices the projection is a ``torch.autograd.Function`` whose
forward is the kernel (CUDA) or the plain version (CPU) and whose backward
is the vector-Jacobian product of ``project_ref``, recomputed from the
saved inputs, as the JAX package's wrapper does with its oracle. No
autograd graph of the plain version is kept between forward and backward
(at 4M Gaussians it would hold GBs per view), and a step runs the same ops
on both devices. The forward reports its work to an active operation
counter (``kernels/cost.py`` ``region``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import gaussians as G
from repro_torch.kernels import _lib
from repro_torch.kernels import cost as _cost
from repro_torch.kernels.gsproject.ref import project_ref
from repro_torch.obs import steptrace

CAM_SLOTS = 32  # viewmat(16), fx, fy, cx, cy, near, campos(3) -> padded to 32
SH_COEFFS = (1, 4, 9, 16)  # per channel, SH degrees 0-3: the kernel's instantiations

launch_count = _lib.LaunchCount()


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


def launch(g, cam_vec: np.ndarray, *, blur: float = 0.3) -> torch.Tensor:
    """Run ``gsproject.cu`` on a CUDA model; returns the (N, 11) packed splats."""
    dev = g.means.device
    if dev.type != "cuda":
        raise ValueError(f"gsproject kernel needs CUDA tensors, got {dev}")
    n = g.means.shape[0]
    for name, x, shape in (("means", g.means, (n, 3)), ("log_scales", g.log_scales, (n, 3)),
                           ("quats", g.quats, (n, 4)), ("opacity_logit", g.opacity_logit, (n,)),
                           ("sh", g.sh, (n, g.sh.shape[1], 3))):
        if x.dtype != torch.float32 or not x.is_contiguous() or x.device != dev or tuple(x.shape) != shape:
            raise ValueError(f"{name}: want contiguous float32 {shape} on {dev}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    cam = np.ascontiguousarray(cam_vec, np.float32)
    if cam.shape != (CAM_SLOTS,):
        raise ValueError(f"camera vector must be ({CAM_SLOTS},), got {cam.shape}")
    lib = _lib.library()
    with _cost.region("gsproject") as r:
        out = torch.empty((n, 11), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.gsproject_fwd(
                g.means.data_ptr(), g.log_scales.data_ptr(), g.quats.data_ptr(), g.opacity_logit.data_ptr(),
                g.sh.data_ptr(), 3 * g.sh.shape[1], cam.ctypes.data, out.data_ptr(), n, blur, stream,
            )
        _lib.check("gsproject_fwd", err)
        if r:
            r.report(*_cost.gsproject_cost(n, g.sh.shape[1]), out)
    launch_count.n += 1
    return out


class Project(torch.autograd.Function):
    """The projection kernel (CUDA) or plain version (CPU) forward; the
    plain version's VJP backward."""

    @staticmethod
    def forward(ctx, means, log_scales, quats, opacity_logit, sh, cam, near: float, blur: float, max_radius: float):
        ctx.near, ctx.blur, ctx.max_radius = near, blur, max_radius
        ctx.trace = steptrace.pin()  # the backward's span joins this step's tree
        if any(ctx.needs_input_grad[:5]):
            # the backward's plain version reads the camera on the device; an
            # asynchronous copy now keeps it from synchronizing the stream then
            ctx.cam = type(cam)(*[torch.as_tensor(x).to(means.device, torch.float32, non_blocking=True)
                                  for x in cam])
        ctx.save_for_backward(means, log_scales, quats, opacity_logit, sh)
        g = G.GaussianModel(means, log_scales, quats, opacity_logit, sh)
        if means.device.type == "cuda":
            return launch(g, cam_vector(cam, near), blur=blur)
        with _cost.region("gsproject") as r:
            out = project_ref(g, cam, near=near, blur=blur, max_radius=max_radius)
            if r:
                r.report(*_cost.gsproject_cost(g.n, sh.shape[1]), out)
        return out

    @staticmethod
    def backward(ctx, gpacked):
        tc, view = ctx.trace
        with steptrace.record(tc, "vjp", view):
            leaves = [x.detach().requires_grad_() for x in ctx.saved_tensors]
            with torch.enable_grad():
                packed = project_ref(G.GaussianModel(*leaves), ctx.cam, near=ctx.near, blur=ctx.blur,
                                     max_radius=ctx.max_radius)
                grads = torch.autograd.grad(packed, leaves, gpacked)
        return (*grads, None, None, None, None)


def project_packed(g, cam, *, near: float = 0.01, blur: float = 0.3, max_radius: float = 1e4) -> torch.Tensor:
    """(N, 11) packed splats: the plain version on CPU, the kernel on CUDA."""
    if g.means.device.type != "cuda":
        return Project.apply(*g, cam, near, blur, max_radius)
    if g.sh.shape[1] not in SH_COEFFS:
        raise NotImplementedError(
            f"the CUDA projection kernel covers SH degrees 0-3; this model has SH degree {g.sh_degree} "
            f"({g.sh.shape[1]} coefficients per channel)"
        )
    if max_radius != 1e4:
        raise NotImplementedError("the CUDA projection kernel clamps the radius at 1e4")
    return Project.apply(*g, cam, near, blur, max_radius)
