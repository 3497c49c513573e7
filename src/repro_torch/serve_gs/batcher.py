"""Request queue + micro-batcher: coalesce concurrent camera requests.

Concurrent clients each want one frame; rendering them one at a time leaves
the accelerator idle between tiny dispatches. The batcher groups pending
requests by LOD level (different levels have different Gaussian counts, hence
different jit shapes) and emits micro-batches padded to a fixed set of bucket
sizes, so every (level, bucket) pair compiles exactly once.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Iterable

import numpy as np

from repro_torch.core.projection import Camera
from repro_torch.obs import new_request_id


@dataclasses.dataclass
class RenderRequest:
    """One client's frame request (host-side; leaves are numpy)."""

    cam: Camera
    level: int = 0
    t_submit: float = 0.0
    client_id: int = -1
    cache_key: tuple | None = None
    timestep: int = 0                    # timeline position (time-scrubbing)
    future: object | None = None         # FrameFuture delivering this frame
    row_levels: tuple | None = None      # per-tile-row LOD map (foveated frames)
    # ids come from the process-wide obs mint so a request keeps one id from
    # gateway admit through batcher queueing to span export
    request_id: int = dataclasses.field(default_factory=new_request_id)


@dataclasses.dataclass(frozen=True)
class MicroBatch:
    """A coalesced render call: ``cams`` is padded to ``bucket`` cameras."""

    level: int
    requests: tuple[RenderRequest, ...]  # the len(requests) real entries
    cams: Camera                         # stacked (bucket, ...) camera pytree
    bucket: int
    timestep: int = 0


def stack_cameras(cams: Iterable[Camera]) -> Camera:
    """Stack single cameras into one batched Camera pytree (numpy leaves)."""
    cams = list(cams)
    return Camera(*[
        np.stack([np.asarray(getattr(c, f), np.float32) for c in cams])
        for f in Camera._fields
    ])


def default_buckets(max_batch: int) -> tuple[int, ...]:
    """Powers of two up to ``max_batch`` (always including max_batch)."""
    b, out = 1, []
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


class MicroBatcher:
    """FIFO-fair request queue emitting fixed-bucket micro-batches.

    Requests group by (timestep, level) — both select a distinct model on the
    device, so a micro-batch must be homogeneous in them. ``next_batch``
    drains up to ``max_batch`` requests of the group whose head request is
    oldest (so no group starves), then pads the camera stack to the smallest
    bucket >= the group size by repeating the last camera; the padded lanes
    are rendered and discarded.
    """

    def __init__(self, *, max_batch: int = 8, buckets: tuple[int, ...] | None = None):
        assert max_batch >= 1
        self.max_batch = max_batch
        self.buckets = tuple(sorted(buckets or default_buckets(max_batch)))
        assert self.buckets[-1] >= max_batch
        self._queues: dict[tuple[int, int], collections.deque[RenderRequest]] = collections.defaultdict(
            collections.deque
        )

    def submit(self, req: RenderRequest) -> int:
        self._queues[(req.timestep, req.level)].append(req)
        return req.request_id

    @property
    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def clear(self) -> int:
        """Drop every queued request (server shutdown); returns the count.
        The caller owns failing the dropped requests' futures."""
        n = self.pending
        self._queues.clear()
        return n

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def next_batch(self) -> MicroBatch | None:
        """Pop the oldest (timestep, level) group as one padded micro-batch
        (None if idle)."""
        live = [(q[0].request_id, key) for key, q in self._queues.items() if q]
        if not live:
            return None
        _, key = min(live)  # request ids are monotonic -> oldest head wins
        ts, lvl = key
        q = self._queues[key]
        reqs = [q.popleft() for _ in range(min(len(q), self.max_batch))]
        bucket = self.bucket_for(len(reqs))
        padded = reqs + [reqs[-1]] * (bucket - len(reqs))
        return MicroBatch(
            level=lvl,
            requests=tuple(reqs),
            cams=stack_cameras(r.cam for r in padded),
            bucket=bucket,
            timestep=ts,
        )
