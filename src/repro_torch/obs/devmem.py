"""Device-memory watermarks: per-device bytes in use and peak (PyTorch).

Port of the JAX package's ``obs/devmem.py`` onto ``torch.cuda.memory_stats``
(the caching allocator's ``allocated_bytes.all.current`` and ``.peak``).
``record()`` lands a sample on a ``MetricsRegistry`` under ``train.devmem.*``
gauges (per-device ``bytes.<dev>`` / ``peak.<dev>`` plus cross-device
maxima). PyTorch keeps no allocator statistics for the CPU, so on a host
without a card the sample is empty and says so in ``source``.
"""
from __future__ import annotations

__all__ = ["DeviceMemSample", "sample", "record"]

import dataclasses

import torch


@dataclasses.dataclass
class DeviceMemSample:
    """One point-in-time reading across the local devices."""

    bytes_in_use: dict   # {device label: bytes currently held}
    peak_bytes: dict     # {device label: peak bytes}
    source: str          # "memory_stats" | "none" (no CUDA device)

    @property
    def max_bytes(self) -> int:
        return max(self.bytes_in_use.values(), default=0)

    @property
    def max_peak(self) -> int:
        return max(self.peak_bytes.values(), default=0)

    def to_dict(self) -> dict:
        return {
            "source": self.source,
            "bytes_in_use": dict(self.bytes_in_use),
            "peak_bytes": dict(self.peak_bytes),
            "max_bytes": self.max_bytes,
            "max_peak": self.max_peak,
        }


def sample(devices=None) -> DeviceMemSample:
    """Read current device-memory occupancy for ``devices`` (default: every
    CUDA device). Never raises on a host without a card."""
    if devices is None:
        devices = range(torch.cuda.device_count()) if torch.cuda.is_available() else ()
    in_use: dict[str, int] = {}
    peak: dict[str, int] = {}
    for dev in devices:
        idx = torch.device("cuda", dev).index if isinstance(dev, int) else torch.device(dev).index
        stats = torch.cuda.memory_stats(idx)
        in_use[f"cuda{idx}"] = int(stats.get("allocated_bytes.all.current", 0))
        peak[f"cuda{idx}"] = int(stats.get("allocated_bytes.all.peak", 0))
    return DeviceMemSample(in_use, peak, "memory_stats" if in_use else "none")


def record(metrics, smp: DeviceMemSample | None = None, *, prefix: str = "train.devmem") -> DeviceMemSample:  # analysis: declare(train.devmem.*)
    """Sample (unless one is passed) and land it on ``metrics`` as gauges:
    ``<prefix>.bytes.<dev>``, ``<prefix>.peak.<dev>``, plus the cross-device
    ``<prefix>.max_bytes`` / ``<prefix>.max_peak`` watermarks."""
    if smp is None:
        smp = sample()
    for dev, b in smp.bytes_in_use.items():
        metrics.gauge(f"{prefix}.bytes.{dev}").set(int(b))
    for dev, b in smp.peak_bytes.items():
        metrics.gauge(f"{prefix}.peak.{dev}").set(int(b))
    metrics.gauge(f"{prefix}.max_bytes").set(smp.max_bytes)
    if smp.peak_bytes:
        metrics.gauge(f"{prefix}.max_peak").set(smp.max_peak)
    return smp
