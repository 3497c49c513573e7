"""Readings of the program's own stage ranges in a ``torch.profiler`` trace.

While a profiler runs, the port opens a range ``gs.<stage>`` around each
stage of its train step (``src/repro_torch/obs/steptrace.py``): a host
event, to which the profiler links the kernels launched inside it through
their correlation ids, as it links an autograd node's
(``profread.node_device_ms``). Here a range is matched by its whole name,
since ``gs.raster`` is a prefix of ``gs.raster_bwd``. A program without the
ranges gives nothing to read: each reading is then None.
"""
from __future__ import annotations

import torch

from gsbench.profread import device_rows

_CUDA = torch.autograd.DeviceType.CUDA
PREFIX = "gs."


def ranges(prof, name: str) -> list:
    """The host events named ``name``, outermost (one inside another of the
    same name counts once)."""
    out = []
    for e in prof.events():
        if e.device_type == _CUDA or e.name != name:
            continue
        parent = e.cpu_parent
        while parent is not None and parent.name != name:
            parent = parent.cpu_parent
        if parent is None:
            out.append(e)
    return out


def range_device_ms(prof, name: str) -> float | None:
    """Device ms of the kernels launched under the ranges named ``name``;
    None when there is no such range."""
    found = ranges(prof, name)
    return sum(e.device_time_total for e in found) / 1e3 if found else None


def idle_gaps(prof) -> list[tuple[float, float]]:
    """(start_us, length_us) of each idle gap between the merged device
    intervals, as ``profread.breakdown`` forms them."""
    merged = []
    for _, s, e in sorted(device_rows(prof), key=lambda r: r[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(a[1], b[0] - a[1]) for a, b in zip(merged, merged[1:])]


def idle_by_range(prof) -> dict:
    """Idle ms by the stage range the host was in when each gap began: the
    innermost ``gs.*`` range (on any thread) whose host interval holds the
    gap's start, and None for a gap that began outside every range. The
    values sum to the whole idle time."""
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
             if e.device_type != _CUDA and e.name.startswith(PREFIX) and e.time_range.end > e.time_range.start]
    out: dict = {}
    for start, length in idle_gaps(prof):
        inner = None
        for s, e, name in spans:
            if s <= start <= e and (inner is None or e - s < inner[1] - inner[0]):
                inner = (s, e, name)
        key = inner[2] if inner is not None else None
        out[key] = out.get(key, 0.0) + length / 1e3
    return out
