"""Multi-stream session layer: many model timelines, one device pool.

**Streams.** A *stream* is one servable model timeline behind a string id — a
static trained scene (one timestep) or a ``TemporalCheckpointStore``-backed
insitu sequence (many). All streams share ONE :class:`RenderServer`: the
server's timeline is an integer axis, so the manager gives every stream a
disjoint block of global positions (``base + local_timestep``, stride 2^20)
and translates ids at the door. Sharing one server is the point — every
stream's requests coalesce into the same micro-batcher, share the same
in-flight ring, frame cache, and per-level render functions, so
adding a stream costs model memory, not a second serving stack.

**Sessions.** A *session* is one connected client: a bounded request queue,
shed accounting, and the per-connection delta-encoder state. Admission
control is oldest-drop load shedding: when a session's queue is full, the
oldest still-queued request is dropped (and answered with ``error/shed``)
rather than the newest — the viewer wants the freshest pose, and a bounded
queue keeps one firehosing client from starving every other session (the
per-session cap is the fairness mechanism; the shed counter is the metric).
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
from typing import Iterable, Mapping

from repro_torch.analysis import tsan
from repro_torch.core import gaussians as G
from repro_torch.core.config import GSConfig
from repro_torch.core.projection import Camera
from repro_torch.frontend import protocol as proto
from repro_torch.frontend.encode import RAW8, TILES8, ZDELTA8, FrameEncoder
from repro_torch.obs import MetricsRegistry, Obs
from repro_torch.obs.clock import now as _now
from repro_torch.serve_gs import RenderServer

STREAM_STRIDE = 1 << 20  # global-timeline block reserved per stream

STATIC, TIMELINE = "static", "timeline"


@dataclasses.dataclass(frozen=True)
class StreamInfo:
    """One registered timeline: wire-visible description + base offset."""

    stream_id: str
    kind: str               # STATIC | TIMELINE
    base: int               # global timeline position of local timestep 0
    timesteps: tuple[int, ...]  # local (client-visible) timesteps
    timestep_set: frozenset = frozenset()  # O(1) membership for resolve()

    def describe(self) -> dict:
        return {"kind": self.kind, "timesteps": list(self.timesteps)}


class SessionManager:
    """Registers streams on one shared ``RenderServer`` and owns its life.

    ``server_kw`` goes to the server as it is, ``device=`` included: the
    server's default is the card, ``device="cpu"`` serves through the plain
    versions."""

    def __init__(self, cfg: GSConfig, *, obs: Obs | None = None, **server_kw):
        self.cfg = cfg
        # one Obs bundle for the whole stack this manager fronts: the shared
        # RenderServer, its cache, every session, and the gateway all meter
        # onto this registry, so one reset()/snapshot() covers every tier
        self.obs = obs if obs is not None else Obs()
        self._server_kw = dict(server_kw)
        self.server: RenderServer | None = None
        self.streams: dict[str, StreamInfo] = {}
        self._next_base = 0
        # streams whose cached content was invalidated since the last
        # take_dirty(), mapped to the dirty tile rows (None = whole frame):
        # the gateway resets their wire delta chains — row-granular when the
        # server computed exact dirty tiles, so the next frame re-keys only
        # those tiles on the wire. Set on the render-executor thread, drained
        # on the loop thread -> locked.
        self._dirty_streams: dict[str, set[int] | None] = {}
        self._dirty_lock = threading.Lock()
        # opt-in runtime race sanitizer (REPRO_TSAN=1; no-op otherwise):
        # verifies the _dirty_lock discipline above actually holds at
        # runtime, including dict mutations the static pass can't see
        tsan.attach(self, name="SessionManager",
                    locks=("_dirty_lock",), dicts=("_dirty_streams",))

    # ------------------------------------------------------------- register
    def _register(
        self, stream_id: str, kind: str, entries: Iterable[tuple[int, G.GaussianModel]]
    ) -> StreamInfo:
        if stream_id in self.streams:
            raise ValueError(f"stream {stream_id!r} already registered")
        entries = list(entries)
        assert entries, f"stream {stream_id!r} has no timesteps"
        locals_ = [int(t) for t, _ in entries]
        assert all(0 <= t < STREAM_STRIDE for t in locals_), locals_
        base = self._next_base
        self._next_base += STREAM_STRIDE
        for t, params in entries:
            if self.server is None:
                self.server = RenderServer(
                    params, self.cfg, timestep=base + int(t), obs=self.obs,
                    **self._server_kw
                )
                self.server.add_invalidation_listener(self._on_invalidate)
            else:
                self.server.add_timestep(base + int(t), params)
        info = StreamInfo(stream_id, kind, base, tuple(locals_), frozenset(locals_))
        self.streams[stream_id] = info
        return info

    def register_static(self, stream_id: str, params: G.GaussianModel) -> StreamInfo:
        """One trained scene as a single-timestep stream."""
        return self._register(stream_id, STATIC, [(0, params)])

    def register_timeline(self, stream_id: str, source, timesteps=None) -> StreamInfo:
        """A temporal sequence as a scrubbable stream.

        ``source`` is anything with ``timesteps()`` and ``load(t)`` (a
        ``TemporalCheckpointStore``) or a ``{timestep: params}`` mapping."""
        if isinstance(source, Mapping):
            entries = sorted((int(t), p) for t, p in source.items())
        else:
            ts = timesteps if timesteps is not None else source.timesteps()
            entries = [(int(t), source.load(t)) for t in ts]
        return self._register(stream_id, TIMELINE, entries)

    # -------------------------------------------------------------- resolve
    def resolve(self, stream_id: str, timestep: int = 0) -> int:
        """(stream id, local timestep) -> global server timeline position."""
        info = self.streams.get(stream_id)
        if info is None:
            raise KeyError(f"unknown stream {stream_id!r} (have {sorted(self.streams)})")
        t = int(timestep)
        if t not in info.timestep_set:  # a full-timeline scrub resolves every
            raise KeyError(             # t on the loop thread: keep it O(1)
                f"stream {stream_id!r} has no timestep {t} (have {list(info.timesteps)})"
            )
        return info.base + t

    def describe(self) -> dict:
        """Wire-facing listing for ``hello_ok``."""
        return {sid: info.describe() for sid, info in self.streams.items()}

    # --------------------------------------------------------- invalidation
    def _on_invalidate(self, global_ts: int, rows=None) -> None:
        """Server invalidation listener: map the global timeline position
        back to its stream and mark its wire delta chains dirty. ``rows`` is
        the server's dirty tile-row set (None = whole frame); repeated
        invalidations before a drain accumulate — a None anywhere dominates
        (full reset), row sets union."""
        if rows is not None and not rows:
            return  # nothing dropped: wire chains stay valid
        for sid, info in self.streams.items():
            if info.base <= global_ts < info.base + STREAM_STRIDE:
                with self._dirty_lock:
                    if sid in self._dirty_streams:
                        prev = self._dirty_streams[sid]
                        if prev is None or rows is None:
                            self._dirty_streams[sid] = None
                        else:
                            prev.update(int(r) for r in rows)
                    else:
                        self._dirty_streams[sid] = (
                            None if rows is None else {int(r) for r in rows}
                        )
                return

    def take_dirty(self) -> dict[str, set[int] | None]:
        """Pop the streams invalidated since the last call (gateway loop):
        stream id -> dirty tile rows, or None for a whole-frame reset."""
        with self._dirty_lock:
            dirty, self._dirty_streams = self._dirty_streams, {}
        return dirty

    def invalidate(self, stream_id: str, timestep: int = 0, *, rows=None) -> int:
        """Invalidate a stream timestep's cached frames (all, or only the
        tile rows in ``rows``). The serving engine is single-threaded by
        contract — from a running gateway, route this through
        ``Gateway.run_on_engine`` like any other engine maintenance."""
        info = self.streams.get(stream_id)
        if info is None:
            raise KeyError(f"unknown stream {stream_id!r} (have {sorted(self.streams)})")
        assert self.server is not None
        return self.server.invalidate(info.base + int(timestep), rows=rows)

    # ------------------------------------------------------------ lifecycle
    def warmup(self) -> float:
        """Render every (level, bucket) variant across all streams.

        One representative timestep per stream suffices: timesteps within a
        stream are shape-uniform (fixed capacity), distinct streams may not
        be. On the card this also builds and loads the kernel library (an
        unlocked ``lru_cache``) on the caller's thread, before a gateway's
        render thread can reach it."""
        assert self.server is not None, "no streams registered"
        return self.server.warmup(
            timesteps=[info.base + info.timesteps[0] for info in self.streams.values()]
        )

    def close(self) -> int:
        """Close the shared server; returns failed queued requests."""
        if self.server is None:
            return 0
        return self.server.close()

    def __enter__(self) -> "SessionManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def report(self) -> dict:
        return {
            "streams": self.describe(),
            "server": self.server.report() if self.server is not None else None,
        }


# --------------------------------------------------------------------------
# per-connection sessions
# --------------------------------------------------------------------------
_session_ids = itertools.count()


@dataclasses.dataclass
class PendingRender:
    """One admitted-but-not-rendered request queued on a session."""

    session: "Session"
    seq: int
    stream_id: str
    timestep: int       # local (client-visible)
    global_ts: int      # resolved server timeline position
    cam: Camera
    t_admit: float
    scrub_last: bool = False  # final item of a scrub fan-out
    bulk: bool = False        # part of a multi-item (scrub) admission unit
    request_id: int = -1      # obs id minted at admit; joins the span tree
    # optional foveated-serving hints, passed through to the engine verbatim
    budget_ms: float | None = None
    gaze: tuple | None = None  # normalized (x, y) in [0, 1]


class Session:
    """One client connection's server-side state (queue, shed, encoder)."""

    def __init__(
        self,
        *,
        queue_limit: int,
        delta_encoding: bool = True,
        tile: tuple[int, int] = (16, 16),
        metrics: MetricsRegistry | None = None,
    ):
        assert queue_limit >= 1, queue_limit
        self.session_id = next(_session_ids)
        self.queue_limit = queue_limit
        self.queue: collections.deque[PendingRender] = collections.deque()
        self.delta_encoding = delta_encoding
        self.tile = (int(tile[0]), int(tile[1]))
        self.protocol = 1  # until the hello negotiates higher
        self.encoder = FrameEncoder(delta=delta_encoding)
        # per-connection lifetime tallies (stats() on the wire). The shared
        # registry additionally aggregates them across sessions under
        # sessions.* so one snapshot/reset covers the session tier too.
        self.shed = 0
        self.admitted = 0
        self.frames_sent = 0
        self.errors_sent = 0
        self._agg_admitted = metrics.counter("sessions.admitted") if metrics else None
        self._agg_shed = metrics.counter("sessions.shed") if metrics else None
        # queue residency (admit -> picked up by a wave, ms), aggregated
        # across sessions: the admission-side half of the served-latency
        # story the SLO window watches on gateway.request_ms
        self._h_queue_ms = metrics.histogram("sessions.queue_ms") if metrics else None
        self.t_connect = _now()

    def admit(self, pr: PendingRender, *, limit: int | None = None) -> PendingRender | None:
        """Queue one request; returns the request shed to make room (the
        OLDEST *sheddable* one), or None when nothing was evicted.

        ``limit`` stretches the cap for one admission (the gateway passes a
        scrub's fan-out size, bounded by the stream's registered timeline
        length). Shedding policy around ``bulk`` (scrub) items — an in-
        progress scrub is one unit of work and must not be nibbled apart:

        * a plain render never evicts a bulk item: if only bulk items are
          queued the queue stretches by one instead (a later render then
          sees THAT render as the oldest sheddable item, so the stretch is
          bounded at one entry past the bulk block);
        * a bulk item may evict bulk items of an OLDER scrub (a new scrub
          displaces a stale one — the oldest-drop rule applied at message
          granularity, which also bounds repeated-scrub queue growth) but
          never items of its own seq.
        """
        victim = None
        if len(self.queue) >= max(self.queue_limit, limit or 0):
            for i, cand in enumerate(self.queue):  # oldest-first scan
                if (not cand.bulk) or (pr.bulk and cand.seq != pr.seq):
                    victim = cand
                    del self.queue[i]
                    self.shed += 1
                    if self._agg_shed:
                        self._agg_shed.inc()
                    break
        self.queue.append(pr)
        self.admitted += 1
        if self._agg_admitted:
            self._agg_admitted.inc()
        return victim

    def negotiate(self, protocol, encodings: Iterable[str] | None) -> int:
        """Pick the session's application protocol + frame encoding from the
        peer's hello. A v1 hello (no ``protocol`` field, or no ``tiles8`` in
        its encodings) keeps the v1 zdelta8/rgb8 wire format; a v2 peer that
        offers ``tiles8`` gets changed-tile streaming. Replaces the encoder
        (no frame has been sent yet — hello is the first exchange)."""
        try:
            self.protocol = max(1, min(int(protocol), proto.PROTOCOL))
        except (TypeError, ValueError):
            self.protocol = 1
        offered = set(encodings) if encodings is not None else {RAW8, ZDELTA8}
        tiles = self.delta_encoding and self.protocol >= 2 and TILES8 in offered
        # never emit an encoding the peer did not offer: a raw-only decoder
        # (encodings=["rgb8"]) must get raw keyframes, not zdelta8
        delta = self.delta_encoding and (tiles or ZDELTA8 in offered)
        self.encoder = FrameEncoder(delta=delta, tiles=tiles, tile=self.tile)
        return self.protocol

    def take(self, n: int) -> list[PendingRender]:
        """Pop up to ``n`` queued requests (FIFO) for a dispatch wave."""
        out = [self.queue.popleft() for _ in range(min(n, len(self.queue)))]
        if self._h_queue_ms is not None and out:
            t = _now()
            for pr in out:
                self._h_queue_ms.observe((t - pr.t_admit) * 1e3)
        return out

    def stats(self) -> dict:
        return {
            "protocol": self.protocol,
            "admitted": self.admitted,
            "frames_sent": self.frames_sent,
            "shed": self.shed,
            "errors_sent": self.errors_sent,
            "queued_now": len(self.queue),
            "queue_limit": self.queue_limit,
            "encoder": self.encoder.stats(),
            "uptime_s": round(_now() - self.t_connect, 3),
        }
