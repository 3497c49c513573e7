"""Process groups and the (data, model) mesh for runs across ranks.

A FUNCTION, not a module constant: importing this module never touches
``torch.distributed`` state. The JAX package's ``make_production_mesh`` is a
TPU pod layout and has no counterpart here.
"""
from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

from repro_torch.core.sharding import Mesh


def init_ranks(device, *, init_method: str = "env://", rank: int | None = None, world_size: int | None = None,
               timeout_s: float = 600.0) -> None:
    """Initialize the default process group with the backend that
    ``device`` needs: NCCL for a CUDA device (bound to it), gloo for the CPU.
    With ``env://`` (torchrun) the rank and world size come from the
    environment; a ``file://`` or ``tcp://`` method takes them as arguments."""
    device = torch.device(device)
    kw = {}
    if rank is not None:
        kw.update(rank=rank, world_size=world_size)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method=init_method,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)


def make_gs_mesh(n_data: int, n_model: int, *, device) -> Mesh:
    """Mesh for distributed 3D-GS runs (paper scaling: 1/2/4 workers) over
    the initialized process group, whose world size must be n_data*n_model."""
    return Mesh(n_data, n_model, device)
