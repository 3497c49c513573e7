"""Batched, LOD-aware render serving for trained Gaussian models (PyTorch).

The port of the JAX package's serving stack: queue -> LOD select -> in-flight
dedup -> tile cache -> a pipelined ring of batched renders (``submit``
returns a ``FrameFuture``; up to ``pipeline_depth`` micro-batches stay
queued on the card while the host retires and assembles). The modules other
than ``server.py`` are host numpy over the port's ``Camera``. See
``launch/serve_gs.py`` for the CLI driver.
"""
from repro_torch.serve_gs.batcher import MicroBatch, MicroBatcher, RenderRequest, stack_cameras
from repro_torch.serve_gs.cache import FrameCache, frame_key, quantize_camera, tile_key
from repro_torch.serve_gs.client import OrbitClient, make_clients, run_load
from repro_torch.serve_gs.footprint import changed_indices, dirty_row_map, dirty_rows
from repro_torch.serve_gs.lod import (
    LODPyramid,
    build_lod_pyramid,
    front_camera,
    importance_scores,
    screen_coverage,
    select_level,
    select_level_map,
)
from repro_torch.serve_gs.server import FrameFuture, RenderServer, TimestepModels

__all__ = [
    "FrameCache",
    "FrameFuture",
    "TimestepModels",
    "LODPyramid",
    "MicroBatch",
    "MicroBatcher",
    "OrbitClient",
    "RenderRequest",
    "RenderServer",
    "build_lod_pyramid",
    "changed_indices",
    "dirty_row_map",
    "dirty_rows",
    "frame_key",
    "front_camera",
    "importance_scores",
    "make_clients",
    "quantize_camera",
    "run_load",
    "screen_coverage",
    "select_level",
    "select_level_map",
    "stack_cameras",
    "tile_key",
]
