"""Synthetic volumes, isosurface extraction and camera rigs (host numpy)."""
from repro_torch.volume.cameras import camera_slice, orbit_cameras
from repro_torch.volume.datasets import VolumeSpec, kingsnake_like, miranda_like
from repro_torch.volume.isosurface import extract_isosurface_points

__all__ = [
    "VolumeSpec",
    "camera_slice",
    "extract_isosurface_points",
    "kingsnake_like",
    "miranda_like",
    "orbit_cameras",
]
