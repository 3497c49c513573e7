"""Synthetic volumes, time-varying streams of them, isosurface extraction
and camera rigs (host numpy)."""
from repro_torch.volume.cameras import camera_slice, orbit_cameras
from repro_torch.volume.datasets import VolumeSpec, kingsnake_like, miranda_like
from repro_torch.volume.isosurface import extract_isosurface_points
from repro_torch.volume.timevary import (
    GENERATORS,
    CallbackStream,
    DiskStream,
    VolumeStream,
    dump_stream,
    kingsnake_uncoil,
    miranda_growth,
    synthetic_stream,
)

__all__ = [
    "GENERATORS",
    "CallbackStream",
    "DiskStream",
    "VolumeSpec",
    "VolumeStream",
    "camera_slice",
    "dump_stream",
    "extract_isosurface_points",
    "kingsnake_like",
    "kingsnake_uncoil",
    "miranda_growth",
    "miranda_like",
    "orbit_cameras",
    "synthetic_stream",
]
