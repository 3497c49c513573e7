"""Tile-granular LRU frame cache keyed by quantized camera pose.

Post hoc exploration revisits poses constantly (orbit playback, multiple
clients on the same trajectory, scrubbing back and forth). Exact float poses
never collide, so keys quantize the extrinsics/intrinsics: poses within the
quantum render identically for all practical purposes and share one entry.
The cache also keys on the LOD level, the timeline position, and the render
resolution — the same pose at a different level, timestep, or output size is
a different frame.

**Tile granularity.** The serving unit stored here is a *tile* (the
rasterizer's ``tile_h x tile_w`` screen tile), not a whole frame: the server
appends a tile index to the frame key (:func:`tile_key`) and stores the
frame as its grid of tiles. Tiles are small and numerous, so capacity is a
**byte budget** rather than an entry count, and identical tile *content* is
stored once (content-addressed blobs with refcounts): the many background
tiles shared by every pose of an orbit cost one buffer, which is what lets a
tile cache hold far more poses than a whole-frame cache of the same byte
size. Whole-frame use (one entry per key, ``tile_cache=False`` servers) is
the degenerate case of the same structure.

**Copy-on-write contract.** One buffer is shared by the cache, the server's
retirement buffer, every deduplicated key, and every waiter's
``FrameFuture`` — a second copy per reader would multiply serving memory for
nothing. ``put`` therefore marks the array read-only
(``arr.setflags(write=False)``) and ``get`` hands the same read-only array to
every hit: a client that wants to draw on its frame must ``.copy()`` it
first, and an accidental in-place mutation raises instead of silently
corrupting every other reader and all later cache hits.
"""
from __future__ import annotations

import collections
import hashlib

import numpy as np

from repro_torch.core.projection import Camera
from repro_torch.obs import MetricsRegistry


def quantize_camera(
    cam: Camera,
    *,
    pose_quantum: float = 1e-3,
    focal_quantum: float = 0.5,
) -> tuple:
    """Hashable key for a camera: viewmat and intrinsics rounded to quanta.

    ``pose_quantum`` applies to every viewmat entry (rotation entries live in
    [-1, 1], translation in scene units); ``focal_quantum`` to fx/fy/cx/cy in
    pixels. Two cameras closer than half a quantum in every entry share a key.
    """
    vm = np.asarray(cam.viewmat, np.float64)
    pose = tuple(int(v) for v in np.round(vm.reshape(-1) / pose_quantum))
    intr = tuple(
        int(np.round(float(np.asarray(x)) / focal_quantum))
        for x in (cam.fx, cam.fy, cam.cx, cam.cy)
    )
    return pose + intr


def frame_key(
    cam: Camera,
    level: int,
    *,
    height: int,
    width: int,
    timestep: int = 0,
    pose_quantum: float = 1e-3,
    focal_quantum: float = 0.5,
) -> tuple:
    """Cache key for a frame: the same pose at another LOD level, *another
    timeline position*, or **another output resolution** is a different
    frame. Resolution is part of the key because the camera alone does not
    carry it — two requests at one quantized pose but different render sizes
    must never share an entry (a hit would return a wrong-size frame)."""
    return (int(timestep), int(level), int(height), int(width)) + quantize_camera(
        cam, pose_quantum=pose_quantum, focal_quantum=focal_quantum
    )


ASSEMBLED = -1  # sentinel tile index: the frame assembled from its tiles


def tile_key(key: tuple, tile_index: int) -> tuple:
    """Key of one screen tile of the frame ``key`` (flat row-major index).
    ``ASSEMBLED`` keys the whole stitched frame — cached alongside its tiles
    so repeated full hits are zero-copy, governed by the same byte budget,
    LRU order, and drop predicates as everything else."""
    return key + (int(tile_index),)


class _Blob:
    """One refcounted content-addressed buffer (shared across equal tiles)."""

    __slots__ = ("data", "digest", "refs")

    def __init__(self, data: np.ndarray, digest: bytes):
        self.data = data
        self.digest = digest
        self.refs = 0


def _digest(arr: np.ndarray) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    h.update(repr((arr.shape, arr.dtype.str)).encode())
    h.update(arr.tobytes())
    return h.digest()


class FrameCache:
    """Bounded LRU mapping frame/tile keys -> arrays, with byte budgeting,
    content dedup, and hit/eviction/invalidation metrics.

    ``capacity`` bounds the *entry count* (legacy whole-frame semantics;
    default 512 so a bare ``FrameCache()`` stays bounded; None = unbounded),
    ``capacity_bytes`` bounds the total bytes of *unique* buffers held (the
    tile-serving budget — pass ``capacity=None`` with it, as the server
    does, since tile entries are far more numerous than frames). Either at 0
    disables the cache entirely. Eviction is LRU by key; a buffer's bytes are
    released only when its last referencing key is gone.

    Metrics live on a :class:`MetricsRegistry` (``obs/metrics.py``) under ``cache.*`` —
    pass the stack's shared registry via ``metrics`` (as ``RenderServer``
    does) so one ``registry.reset()`` clears the cache window together with
    every other tier; a standalone cache gets a private registry. The
    historical attribute reads (``cache.hits`` etc.) remain as properties.
    Structural state (entries, bytes held) is NOT metrics and survives reset.
    """

    def __init__(
        self,
        capacity: int | None = 512,
        *,
        capacity_bytes: int | None = None,
        dedup: bool = True,
        metrics: MetricsRegistry | None = None,
    ):
        assert capacity is None or capacity >= 0
        assert capacity_bytes is None or capacity_bytes >= 0
        self.capacity = capacity
        self.capacity_bytes = capacity_bytes
        self.dedup = dedup
        self._store: collections.OrderedDict[tuple, _Blob] = collections.OrderedDict()
        self._blobs: dict[bytes, _Blob] = {}
        self._bytes = 0
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._hits = self.metrics.counter("cache.hits")
        self._misses = self.metrics.counter("cache.misses")
        self._evictions = self.metrics.counter("cache.evictions")
        self._dropped = self.metrics.counter("cache.dropped")
        self._dedup_shared = self.metrics.counter("cache.dedup_shared")
        self._dedup_bytes_saved = self.metrics.counter("cache.dedup_bytes_saved")

    # historical attribute reads, now backed by the shared registry
    @property
    def hits(self) -> int:
        return self._hits.value

    @property
    def misses(self) -> int:
        return self._misses.value

    @property
    def evictions(self) -> int:
        return self._evictions.value

    @property
    def dropped(self) -> int:
        """Entries removed by drop() (invalidation)."""
        return self._dropped.value

    @property
    def dedup_shared(self) -> int:
        """Puts that reused an existing buffer."""
        return self._dedup_shared.value

    @property
    def dedup_bytes_saved(self) -> int:
        return self._dedup_bytes_saved.value

    def __len__(self) -> int:
        return len(self._store)

    @property
    def bytes(self) -> int:
        """Total bytes of unique buffers currently held."""
        return self._bytes

    @property
    def disabled(self) -> bool:
        return self.capacity == 0 or self.capacity_bytes == 0

    def get(self, key: tuple) -> np.ndarray | None:
        blob = self._store.get(key)
        if blob is None:
            self._misses.inc()
            return None
        self._store.move_to_end(key)
        self._hits.inc()
        return blob.data

    # ------------------------------------------------------------- refcounts
    def _incref(self, blob: _Blob) -> None:
        if blob.refs == 0:
            self._bytes += blob.data.nbytes
            if blob.digest is not None:
                self._blobs[blob.digest] = blob
        blob.refs += 1

    def _decref(self, blob: _Blob) -> None:
        blob.refs -= 1
        if blob.refs == 0:
            self._bytes -= blob.data.nbytes
            if blob.digest is not None:
                self._blobs.pop(blob.digest, None)

    def _remove(self, key: tuple) -> None:
        self._decref(self._store.pop(key))

    def put(self, key: tuple, frame: np.ndarray, *, dedup: bool | None = None) -> None:
        """Insert an array. The cache owns the buffer from here on: it is
        marked read-only (see the module docstring's copy-on-write contract),
        so callers must not hold a writable alias. Identical content (same
        shape + bytes) already in the cache is shared, not stored twice;
        ``dedup=False`` skips the content hash for entries that essentially
        never collide (whole assembled frames)."""
        if self.disabled:
            return
        if not frame.flags.c_contiguous:
            frame = np.ascontiguousarray(frame)
        elif frame.base is not None:
            # a contiguous VIEW (e.g. a full-width tile row slice) would pin
            # its whole parent buffer while the budget counts only the slice
            frame = frame.copy()
        frame.setflags(write=False)
        dedup = self.dedup if dedup is None else dedup
        digest = _digest(frame) if dedup else None
        blob = self._blobs.get(digest) if digest is not None else None
        if blob is not None:
            self._dedup_shared.inc()
            self._dedup_bytes_saved.inc(frame.nbytes)
        else:
            blob = _Blob(frame, digest)
        old = self._store.get(key)
        if old is not None:
            if old is blob:
                self._store.move_to_end(key)
                return
            self._remove(key)
        self._incref(blob)
        self._store[key] = blob
        while (self.capacity is not None and len(self._store) > self.capacity) or (
            self.capacity_bytes is not None and self._bytes > self.capacity_bytes
        ):
            victim, vblob = self._store.popitem(last=False)
            self._decref(vblob)
            self._evictions.inc()
            if victim == key:  # a single entry larger than the whole budget
                break

    def drop(self, predicate) -> int:
        """Invalidate every entry whose key matches ``predicate``; returns
        the count dropped (e.g. all tiles of a replaced timeline timestep, or
        only the tiles of its dirty rows). Unlike eviction this is an
        explicit correctness action, accounted separately (``dropped``)."""
        keys = [k for k in self._store if predicate(k)]
        for k in keys:
            self._remove(k)
        self._dropped.inc(len(keys))
        return len(keys)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        return {
            "size": len(self._store),
            "bytes": self._bytes,
            "capacity": self.capacity,
            "capacity_bytes": self.capacity_bytes,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "dropped": self.dropped,
            "hit_rate": round(self.hit_rate, 4),
            "unique_buffers": sum(1 for _ in self._iter_unique()),
            "dedup_shared": self.dedup_shared,
            "dedup_bytes_saved": self.dedup_bytes_saved,
        }

    def _iter_unique(self):
        seen = set()
        for blob in self._store.values():
            if id(blob) not in seen:
                seen.add(id(blob))
                yield blob
