"""Streaming time-varying volume reconstruction (the paper's in situ goal),
PyTorch port of the JAX package's ``insitu``.

The static pipeline trains one volume from scratch; this subsystem consumes a
*sequence* of evolving timesteps (``repro_torch.volume.timevary``) and keeps
one fixed-capacity Gaussian model tracking the isosurface:

  stream -> extract -> reseed dead slots -> warm-start delta-optimize
         -> temporal checkpoint (keyframe + quantized delta)
         -> time-scrub serving (timeline RenderServer)

See ``repro_torch.launch.insitu`` for the CLI driver and
``benchmarks/insitu_throughput_torch.py`` for the warm-vs-cold methodology.
"""
from repro_torch.insitu.serve import build_timeline_server, replay_live, scrub, timeline_stream
from repro_torch.insitu.store import TemporalCheckpointStore
from repro_torch.insitu.trainer import (
    InsituTrainer,
    TimestepReport,
    fixed_capacity_init,
    reseed_dead_slots,
)

__all__ = [
    "InsituTrainer",
    "TemporalCheckpointStore",
    "TimestepReport",
    "build_timeline_server",
    "fixed_capacity_init",
    "replay_live",
    "reseed_dead_slots",
    "scrub",
    "timeline_stream",
]
