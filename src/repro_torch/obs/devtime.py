"""Device busy time of one profiled stretch of work (PyTorch; the port's own).

``device_time(prof, wall_ms)`` reads a ``torch.profiler`` trace: the device
rows (kernels, copies, fills) as intervals on the card's timeline. The busy
time is the union of those intervals, so kernels that run side by side on
several streams (NCCL beside the compute stream) count once, and its share
is taken of the wall time of the same profiled work. NCCL kernels and the
rest are reported as unions of their own, with the time they overlap.
"""
from __future__ import annotations

__all__ = ["union_ms", "device_time"]

import torch


def union_ms(intervals) -> float:
    """Length in ms of the union of ``(start_us, end_us)`` intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def device_time(prof, wall_ms: float) -> dict:
    """Busy time of the device rows of ``prof`` (a finished
    ``torch.profiler.profile``) over ``wall_ms``, the wall time of the
    profiled work itself: ``busy_ms`` (union of every device interval),
    ``busy_share``, ``nccl_ms`` and ``other_ms`` (unions of the NCCL
    kernels' and of the other rows' intervals; NCCL time includes the wait
    for other ranks), ``overlap_ms`` (the time both ran at once),
    ``summed_ms`` (the rows' device time added up) and ``n_ops``."""
    rows = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and e.time_range.end > e.time_range.start]
    nccl = [(e.time_range.start, e.time_range.end) for e in rows if "nccl" in e.name.lower()]
    other = [(e.time_range.start, e.time_range.end) for e in rows if "nccl" not in e.name.lower()]
    busy = union_ms(nccl + other)
    nccl_ms, other_ms = union_ms(nccl), union_ms(other)
    return {"busy_ms": busy, "wall_ms": wall_ms, "busy_share": busy / wall_ms if wall_ms > 0 else None,
            "nccl_ms": nccl_ms, "other_ms": other_ms, "overlap_ms": nccl_ms + other_ms - busy,
            "summed_ms": sum(e - s for s, e in nccl + other) / 1e3, "n_ops": len(rows)}
