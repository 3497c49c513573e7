"""Readings of a ``torch.profiler`` trace for the per-layer metrics.

The busy time is the union of the device intervals (kernels, copies,
fills), so work on several streams at once counts once: a copy of the
arithmetic of the port's ``obs/devtime.py``. A layer's device time is the
device time of the kernels launched inside the outermost host ops whose
name holds the layer's autograd node (``ProjectBackward``), which the
profiler links through its correlation ids.
"""
from __future__ import annotations

import torch

_CUDA = torch.autograd.DeviceType.CUDA


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


def device_rows(prof) -> list[tuple[str, float, float]]:
    """(name, start_us, end_us) of every device row with a duration."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == _CUDA and e.time_range.end > e.time_range.start]


def is_nccl(name: str) -> bool:
    return "nccl" in name.lower()


def node_device_ms(prof, part: str) -> float:
    """Device ms of the kernels under the outermost host ops whose name
    holds ``part`` (an op nested in another match counts once)."""
    total = 0.0
    for e in prof.events():
        if e.device_type == _CUDA or part not in e.name:
            continue
        parent, nested = e.cpu_parent, False
        while parent is not None:
            if part in parent.name:
                nested = True
                break
            parent = parent.cpu_parent
        if not nested:
            total += e.device_time_total
    return total / 1e3


def kernel_ms(prof, part: str) -> list[float]:
    """Device ms of each kernel whose name holds ``part``."""
    return [(e - s) / 1e3 for name, s, e in device_rows(prof) if part in name]


def short(name: str, width: int = 96) -> str:
    """A kernel's name without ``void`` and cut to ``width`` characters."""
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= width else name[:width - 3] + "..."


def breakdown(prof) -> dict:
    """The contract's ``breakdown``: the ten device ops that took most time
    (seconds, summed by name), and the ten longest idle gaps between device
    intervals, each named by the innermost host op running when it began.
    Names are cut to 96 characters."""
    rows = device_rows(prof)
    by_name: dict[str, float] = {}
    for name, s, e in rows:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    merged = []
    for _, s, e in sorted(rows, key=lambda r: r[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(merged, merged[1:])), reverse=True)[:10]
    host = [e for e in prof.events() if e.device_type != _CUDA and e.time_range.end > e.time_range.start]
    named = []
    for length, start in gaps:
        inner = None
        for e in host:
            if e.time_range.start <= start <= e.time_range.end and (
                    inner is None or e.time_range.end - e.time_range.start < inner.time_range.end - inner.time_range.start):
                inner = e
        named.append([inner.name if inner is not None else "no host op", length / 1e6])
    return {"device_ops": [[short(n), s] for n, s in ops], "idle_gaps": [[short(n), s] for n, s in named]}
