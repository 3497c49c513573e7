"""Time-scrub serving: a temporal checkpoint store -> timeline RenderServer
(PyTorch port of the JAX package's ``insitu/serve.py``).

Post hoc exploration of a streamed reconstruction is scrubbing: the client
holds a camera and drags a time slider; every (timestep, pose) frame should
be servable at interactive rates and cacheable. This module assembles a
``RenderServer`` whose timeline is the store's timestep sequence — one LOD
pyramid per timestep, all sharing the per-level render fns (a
fixed-capacity insitu run is shape-uniform). The server renders on the
card unless ``device="cpu"`` is passed through ``server_kw``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.config import GSConfig
from repro_torch.core.projection import Camera
from repro_torch.insitu.store import TemporalCheckpointStore
from repro_torch.serve_gs import RenderServer


def build_timeline_server(
    store: TemporalCheckpointStore,
    cfg: GSConfig,
    *,
    timesteps: list[int] | None = None,
    **server_kw,
) -> RenderServer:
    """Load (a subset of) the stored sequence into one timeline server."""
    ts = timesteps if timesteps is not None else store.timesteps()
    assert ts, "temporal store is empty"
    server = RenderServer(store.load(ts[0]), cfg, timestep=ts[0], **server_kw)
    for t in ts[1:]:
        server.add_timestep(t, store.load(t))
    return server


def replay_live(
    store: TemporalCheckpointStore,
    server: RenderServer,
    *,
    timesteps: list[int] | None = None,
    serve_timestep: int = 0,
    on_timestep=None,
):
    """Replay a stored sequence through ONE live timeline slot.

    The post hoc twin of ``InsituTrainer.run(server=...)``: each stored
    timestep re-registers ``serve_timestep`` with the slots the stored delta
    encoding says changed (``store.changed_slots``), so the server's
    world-space invalidation drops only the tiles those Gaussians can touch
    under each cached pose — no caller row math. Keyframes (unknown change
    set) fall back to a full drop. ``on_timestep(t)`` runs after each
    registration (e.g. to submit viewer requests between updates).
    """
    ts = timesteps if timesteps is not None else store.timesteps()
    assert ts, "temporal store is empty"
    for t in ts:
        params = store.load(t)
        slots = store.changed_slots(t)
        if slots is None or int(serve_timestep) not in server.timesteps():
            server.add_timestep(int(serve_timestep), params)
        else:
            server.add_timestep(int(serve_timestep), params, changed=slots)
        if on_timestep is not None:
            on_timestep(t)


def timeline_stream(manager, stream_id: str, store: TemporalCheckpointStore, *, timesteps=None):
    """Expose a stored insitu sequence as a scrubbable network stream.

    The frontend-facing twin of :func:`build_timeline_server`: instead of a
    private server, the sequence is registered on a shared session
    manager's pool under ``stream_id``: remote clients then scrub it with
    ``scrub`` messages while other streams (static scenes, other runs)
    share the same device pool, micro-batcher, and frame cache. Returns the
    registered ``StreamInfo``."""
    return manager.register_timeline(stream_id, store, timesteps=timesteps)


def scrub(server: RenderServer, cam: Camera, timesteps: list[int]) -> dict[int, np.ndarray]:
    """Request the same camera across ``timesteps``; returns t -> frame.

    The playback primitive: a client dragging the time slider at a fixed
    viewpoint. Frames come back per-timestep distinct and individually
    cached (a second scrub over the same range is all cache hits). Frames are
    delivered through each request's ``FrameFuture`` — no reliance on the
    server's retirement buffer, so this works on servers built with
    ``store_frames=False`` (the production configuration). ``run`` drains the
    whole scrub through the pipelined dispatcher before the futures are read,
    so awaiting them never blocks.
    """
    futures = {t: server.submit(cam, timestep=t) for t in timesteps}
    server.run()
    return {t: fut.result() for t, fut in futures.items()}
