"""PyTorch port, ``obs/devtime.py``: a profiled step's device busy time is
the union of its device intervals, so rows on several streams (NCCL beside
the compute stream) count once and the share stays within the wall."""
from types import SimpleNamespace

import pytest
import torch

from repro_torch.obs.devtime import device_time, union_ms


@pytest.mark.parametrize("intervals, want_ms", [
    ([], 0.0),
    ([(0, 1000)], 1.0),
    ([(0, 1000), (2000, 2500)], 1.5),          # disjoint
    ([(0, 1000), (500, 1500)], 1.5),           # overlapping
    ([(0, 3000), (500, 1500), (1000, 2000)], 3.0),  # nested
    ([(1000, 2000), (0, 1000)], 2.0),          # touching, out of order
])
def test_union_ms(intervals, want_ms):
    assert union_ms(intervals) == pytest.approx(want_ms)


def _event(name, start, end, device_type=torch.autograd.DeviceType.CUDA):
    return SimpleNamespace(name=name, device_type=device_type, time_range=SimpleNamespace(start=start, end=end))


def test_device_time_counts_overlapping_streams_once():
    prof = SimpleNamespace(events=lambda: [
        _event("tile_raster_fwd_kernel", 0, 4000),
        _event("ncclDevKernel_AllGather_RING_LL", 3000, 9000),   # beside the compute stream
        _event("elementwise_kernel", 8000, 10000),
        _event("aten::add", 0, 10000, torch.autograd.DeviceType.CPU),  # a host row: not device time
    ])
    d = device_time(prof, wall_ms=12.0)
    assert d["busy_ms"] == pytest.approx(10.0) and d["summed_ms"] == pytest.approx(12.0)
    assert d["nccl_ms"] == pytest.approx(6.0) and d["other_ms"] == pytest.approx(6.0)
    assert d["overlap_ms"] == pytest.approx(2.0)
    assert d["busy_share"] == pytest.approx(10.0 / 12.0) and d["n_ops"] == 3


def test_device_time_of_a_host_only_profile_is_zero():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    d = device_time(prof, wall_ms=1.0)
    assert d["busy_ms"] == 0.0 and d["n_ops"] == 0 and d["busy_share"] == 0.0
