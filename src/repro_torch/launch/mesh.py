"""Process groups and meshes: the (data, model) mesh for runs across ranks,
and the production cluster's layout with its H100 hardware constants.

FUNCTIONS, not module constants: importing this module never touches
``torch.distributed`` state. ``make_production_mesh`` is the counterpart of
the JAX package's TPU pod mesh on an H100 cluster: a logical mesh (axis
sizes only, no process group) with the JAX package's chip counts, 256
cards on one pod and 512 on two, and the model axis inside one NVLink node
of 8 cards. The dry run (``launch/dryrun.py``) reads its shape to resolve
partition specs and the constants below to turn counts into times.
"""
from __future__ import annotations

import datetime
import time

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


# NVIDIA H100 SXM 80 GB data-sheet constants at its 700 W limit, per card
# (dense rates, no sparsity), under the JAX package's names
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, bfloat16 on the tensor cores
PEAK_FLOPS_FP32 = 67e12         # FLOP/s, float32 outside the tensor cores
HBM_BW = 3.35e12                # B/s, HBM3
NVLINK_BW = 450e9               # B/s per direction, NVLink 4 (the model axis, inside a node)
NET_BW = 50e9                   # B/s, one 400 Gb/s NDR adapter per card (the data and pod axes)
HBM_BYTES = 80e9                # device memory
NODE_CARDS = 8                  # cards per NVLink node


class LogicalMesh:
    """A mesh's axis sizes (``.shape``, name -> size, in order) without any
    process group: what partition rules and the dry run's cost model read."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    def __repr__(self) -> str:
        return f"LogicalMesh({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    """The production H100 cluster as a logical mesh: (data 32, model 8) =
    256 cards, or (pod 2, data 32, model 8) = 512; the model axis is one
    NVLink node of 8 cards, the data and pod axes cross the network."""
    if multi_pod:
        return LogicalMesh({"pod": 2, "data": 32, "model": NODE_CARDS})
    return LogicalMesh({"data": 32, "model": NODE_CARDS})


def axis_bandwidth(axis: str) -> float:
    """Per-card link bandwidth (B/s) of a production mesh axis."""
    return NVLINK_BW if axis == "model" else NET_BW


def make_gs_mesh(n_data: int, n_model: int, *, device) -> Mesh:
    """Mesh for distributed 3D-GS runs (paper scaling: 1/2/4 workers) over
    the initialized process group, whose world size must be n_data*n_model."""
    return Mesh(n_data, n_model, device)


def spawn_ranks(fn, args: tuple, nprocs: int, *, timeout_s: float) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` spawned processes, one per rank
    (``fn`` must be importable by name, as a module-level function), and
    wait for all of them. Raises if a rank raises or exits non-zero (the
    others are then stopped) or if they are not all done in ``timeout_s``."""
    ctx = torch.multiprocessing.start_processes(fn, args=args, nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"spawn_ranks: {nprocs} ranks of {fn.__name__} did not finish in {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
