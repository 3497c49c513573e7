"""The render server: queue -> LOD select -> dedup -> pipelined batched render.

Turns trained ``GaussianModel``s into a service. Requests are admitted via
``submit``, which returns a :class:`FrameFuture` (cache hits come back already
resolved); ``step`` advances the dispatch pipeline by one unit; ``run`` drains
everything pending. All orchestration is host-side Python; the device only
sees (level, bucket) batched render calls of the port's eval-render
factories (``core/train.py``), which run the hand-written CUDA kernels when
the server's device is a card and the plain PyTorch versions on the CPU.

**Pipelined dispatch.** The serve loop is a bounded in-flight ring of depth
``pipeline_depth`` (default 2). ``step`` first *dispatches* micro-batches —
the render call returns once its kernels are queued (PyTorch launches
asynchronously on the card), and the dispatch also queues a non-blocking copy
of the frames into pinned host memory followed by a CUDA event — until the
ring is full, then *retires* the oldest in-flight batch: wait on its event,
copy frames out, fill the cache, resolve futures. (A ``.cpu()`` at dispatch
would wait for the render and silently make every depth 1.) While the device
renders batch N the host is therefore postprocessing batch N-1 and assembling
batch N+1; the host only blocks when the ring is full or a future is awaited. ``pipeline_depth=1`` is
the old synchronous dispatch-then-block loop, preserved bit-for-bit.

**In-flight dedup.** A pending-key table maps each in-flight ``frame_key`` to
its future: submitting a pose that quantizes onto an in-flight render attaches
the new request to the existing future instead of rendering twice (the
cross-request dedup the cache alone cannot provide — the first render has not
landed yet, so the cache misses).

**Tile-granular serving.** With ``tile_cache=True`` (the default) the frame
is the unit of *assembly*, not the unit of work: retired frames are stored in
the cache as their grid of rasterizer tiles (content-deduplicated, byte
budgeted — see ``cache.py``), ``submit`` probes the tile grid, and a pose
whose tiles are only *partially* cached renders **only the missing tile
rows** (``make_tile_row_render`` strips, bit-identical to the same rows of
the full-frame render) before assembling the frame. Partial hits arise from
byte-budget eviction and — the paper's in situ story — from *partial
invalidation*: ``add_timestep(..., changed=<slot indices>)`` projects the
changed Gaussians' conservative screen bounds through every cached pose and
drops only the tile rows the update can touch (``dirty_rows=`` remains the
manual escape hatch), so revisiting a pose after a localized simulation
update re-renders a few rows instead of the frame. Requests may also opt
into **foveated per-tile LOD** (``submit(..., gaze=, budget_ms=)``): tile
rows get their own pyramid level, mixed-level frames assemble from the same
per-(tile, level) cache entries uniform frames populate.
``tile_cache=False`` is the whole-frame baseline, preserved bit-for-bit.

The server holds a *timeline*: timestep -> (LOD pyramid, device params).
Static scenes are the one-entry special case (timestep 0, the default).
Streaming reconstructions (the JAX package's in situ trainer) register one
model per simulation timestep via ``add_timestep``, and clients scrub time by
submitting the same camera with different ``timestep`` values — each
(timestep, level, pose) is a distinct cacheable frame. The render fns are shared across the whole
timeline.

This is the JAX package's server on one ``torch.device``: the mesh and its
shardings are gone (sharded serving comes with the port's multi-rank slice),
the level parameters live on the server's device, and there is no jit cache
to count or warm beyond the kernel library build.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import gaussians as G
from repro_torch.core.config import GSConfig
from repro_torch.core.projection import Camera, camera_to_numpy
from repro_torch.core.train import make_batched_eval_render, make_tile_row_render
from repro_torch.obs import DEFAULT_SIZE_BUCKETS, Obs
from repro_torch.obs.clock import now as _now
from repro_torch.serve_gs.batcher import (
    MicroBatch,
    MicroBatcher,
    RenderRequest,
    default_buckets,
    stack_cameras,
)
from repro_torch.serve_gs.cache import ASSEMBLED, FrameCache, frame_key, quantize_camera, tile_key
from repro_torch.serve_gs.footprint import changed_indices, dirty_row_map
from repro_torch.serve_gs.lod import (
    LODPyramid,
    build_lod_pyramid,
    front_camera,
    select_level,
    select_level_map,
)


def _host_model(params) -> G.GaussianModel:
    """Host (float32 numpy-leaf) copy of a model given as tensors or arrays."""
    return G.to_numpy(G.GaussianModel(*params))


def _percentile(xs: list[float], q: float) -> float:
    """Exact percentile over a raw sample list (benchmark clients keep raw
    client-side latency samples; the serving tiers use registry histograms)."""
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else 0.0


class FrameFuture:
    """Host-side handle for one (possibly still in-flight) frame.

    Every ``submit`` returns one; requests whose ``frame_key`` matches an
    in-flight render share a single future (in-flight dedup), so ``requests``
    may hold several waiters. ``result()`` drives the server's pipeline until
    the frame lands; the returned array is **read-only** (it is shared with
    the cache and every deduped waiter) — ``.copy()`` it to mutate.
    """

    __slots__ = ("key", "requests", "_frame", "_error", "_server")

    def __init__(self, server: "RenderServer", key: tuple, req: RenderRequest):
        self.key = key
        self.requests: list[RenderRequest] = [req]
        self._frame: np.ndarray | None = None
        self._error: BaseException | None = None
        self._server = server

    @property
    def request_id(self) -> int:
        """Id of the primary (first-submitted) request."""
        return self.requests[0].request_id

    def done(self) -> bool:
        return self._frame is not None or self._error is not None

    def result(self) -> np.ndarray:
        """The frame, blocking (and driving the pipeline) until it lands.

        Raises the failure instead if the future was failed (e.g. the server
        was closed while this request was still queued)."""
        while self._frame is None:
            if self._error is not None:
                raise self._error
            if not self._server._advance():
                raise RuntimeError(
                    f"FrameFuture {self.key} cannot resolve: server pipeline is idle"
                )
        return self._frame

    # -------------------------------------------------------------- internal
    def _attach(self, req: RenderRequest) -> None:
        assert not self.done(), "cannot attach to a resolved future"
        self.requests.append(req)

    def _fail(self, err: BaseException) -> None:
        """Mark every attached request as failed; ``result()`` raises."""
        assert self._frame is None, "cannot fail a resolved future"
        self._error = err

    def _resolve(self, frame: np.ndarray) -> int:
        """Deliver ``frame`` to every attached request; returns the count."""
        self._frame = frame
        for req in self.requests:
            self._server._complete(req, frame)
        return len(self.requests)


@dataclasses.dataclass
class _InFlight:
    """One dispatched-but-not-retired micro-batch in the pipeline ring."""

    mb: MicroBatch
    imgs: torch.Tensor       # host frames (pinned; filled by a queued copy on a card)
    ready: object            # torch.cuda.Event recorded after the copy, or None on CPU
    t_dispatch: float


@dataclasses.dataclass
class _PartialJob:
    """One partially-cached frame awaiting its missing tile rows.

    ``tiles`` is the frame's full tile grid (row-major flat); ``None`` slots
    are the tiles a strip render must fill. The job pins its cached tiles, so
    later eviction cannot take them back out from under the assembly."""

    req: RenderRequest
    fut: "FrameFuture"
    tiles: list
    # foveated frames: per-tile-row LOD levels and the uniform-level frame
    # keys whose tile entries the rows share (None -> uniform at req.level)
    row_levels: tuple | None = None
    row_keys: tuple | None = None


class TimestepModels(NamedTuple):
    """One timeline entry: the pyramid and its device-resident levels."""

    pyramid: LODPyramid
    level_params: tuple[G.GaussianModel, ...]  # tensors on the server's device


class RenderServer:
    """Batched, LOD-aware, cached, pipelined render service over a timeline."""

    def __init__(
        self,
        params: G.GaussianModel,
        cfg: GSConfig,
        *,
        device="cuda",
        n_levels: int = 3,
        keep_ratio: float = 0.5,
        max_batch: int = 8,
        buckets: tuple[int, ...] | None = None,
        cache_capacity: int = 512,
        cache_bytes: int | None = None,
        tile_cache: bool = True,
        pose_quantum: float = 1e-3,
        store_frames: bool = True,
        frames_capacity: int = 256,
        pipeline_depth: int = 2,
        timestep: int = 0,
        pose_registry_cap: int = 512,
        obs: Obs | None = None,
    ):
        self.cfg = cfg
        # the observability bundle every tier of this stack shares: one
        # metrics registry (atomic snapshot, one reset) + the span recorder
        # (falsy NULL_RECORDER unless tracing is enabled)
        self.obs = obs if obs is not None else Obs()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "RenderServer(device='cuda') needs a CUDA device; pass device='cpu' "
                "to serve through the plain PyTorch versions"
            )
        self.pose_quantum = pose_quantum
        self.store_frames = store_frames
        self.frames_capacity = max(int(frames_capacity), 1)
        assert pipeline_depth >= 1, pipeline_depth
        self.pipeline_depth = int(pipeline_depth)
        self.n_levels = n_levels
        self.keep_ratio = keep_ratio

        # ---- tile geometry (the rasterizer's tiling, reused as cache grid)
        self.tile_cache = bool(tile_cache)
        self.tile_h, self.tile_w = int(cfg.tile_h), int(cfg.tile_w)
        if self.tile_cache:
            assert cfg.img_h % self.tile_h == 0 and cfg.img_w % self.tile_w == 0, (
                "tile-granular caching needs the image to tile evenly "
                f"({cfg.img_h}x{cfg.img_w} vs {self.tile_h}x{self.tile_w}); "
                "pass tile_cache=False for ragged configs"
            )
        self.tiles_y = cfg.img_h // self.tile_h
        self.tiles_x = cfg.img_w // self.tile_w
        self.n_tiles = self.tiles_y * self.tiles_x

        max_batch = max(int(max_batch), 1)
        if buckets is None:
            buckets = default_buckets(max_batch)
        # A level with keep_ratio**k of the Gaussians needs proportionally
        # fewer splats per tile: compositing is O(tiles x k_per_tile) and is
        # the dominant render term, so shrinking K is what actually makes a
        # coarse level cheap (pruning alone only shrinks project/sort/bin).
        self._level_cfgs = tuple(
            dataclasses.replace(
                cfg,
                k_per_tile=max(int(cfg.k_per_tile * keep_ratio**lvl), 32),
            )
            for lvl in range(n_levels)
        )
        # one render fn per level, shared by every timeline entry
        self._level_render = tuple(
            make_batched_eval_render(c) for c in self._level_cfgs  # analysis: allow(retrace.factory_in_loop, one factory call per LOD level at construction; cached in _level_render for the server lifetime)
        )

        # Pose registry: every pose that ever populated the tile cache, keyed
        # by its quantized-camera signature (the pose part of the cache key).
        # World-space invalidation projects changed Gaussians through these
        # cameras to find each pose's dirty tile rows. Bounded LRU: an entry
        # evicted here makes that pose's cached tiles *conservatively* dropped
        # on the next world-space invalidation (unknown pose -> assume dirty).
        self.pose_registry_cap = max(int(pose_registry_cap), 1)
        self._poses: collections.OrderedDict[tuple, Camera] = collections.OrderedDict()
        # EWMA of the wall cost of one level-0 tile row (ms), level-normalized
        # (a level-l row counts as keep_ratio**l of a row); calibrates the
        # budget_ms -> budget_rows mapping for foveated requests
        self._row_cost_ms: float | None = None

        self._timeline: dict[int, TimestepModels] = {}
        self._first_timestep = int(timestep)
        self.add_timestep(timestep, params)

        self.batcher = MicroBatcher(max_batch=max_batch, buckets=buckets)
        # Capacity is a byte budget: tile entries are far smaller and more
        # numerous than frames, so an entry count is meaningless across
        # granularities. ``cache_capacity`` (frames) preserves the historical
        # "N cached poses" meaning: a tile-cached pose costs up to TWO frame
        # equivalents (its tiles + the zero-copy stitched frame), so the
        # conversion doubles in tile mode; content dedup claws much of the
        # tile half back. ``cache_bytes`` sets the budget directly.
        # Either at 0 disables caching.
        frame_nbytes = cfg.img_h * cfg.img_w * 3 * 4  # float32 RGB
        per_pose = frame_nbytes * (2 if self.tile_cache else 1)
        self.cache = FrameCache(
            capacity=None,  # the byte budget is the bound, not entry count
            capacity_bytes=int(cache_bytes) if cache_bytes is not None
            else int(cache_capacity) * per_pose,
            # content dedup pays at tile granularity (shared background
            # tiles); whole frames essentially never collide, so the
            # baseline skips the per-put hash entirely
            dedup=self.tile_cache,
            metrics=self.obs.metrics,
        )
        # bounded retirement buffer of recently served frames (request_id ->
        # frame); a sustained-load server must not pin every frame ever served
        self.frames: collections.OrderedDict[int, np.ndarray] = collections.OrderedDict()

        # ---- pipeline state
        self._ring: collections.deque[_InFlight] = collections.deque()
        self._pending: dict[tuple, FrameFuture] = {}  # in-flight key -> future
        self._partial: collections.deque[_PartialJob] = collections.deque()
        self._strip_renders: dict[tuple[int, int], object] = {}  # (level, row)
        self._invalidation_listeners: list = []
        self._closed = False

        # ---- metrics: typed registry entries under server.* (see obs/metrics.py).
        # Everything here is a WINDOW quantity — one registry.reset() zeroes
        # it across this tier and every other tier sharing the registry.
        m = self.obs.metrics
        self._completed = m.counter("server.completed")
        self._deduped = m.counter("server.deduped")
        self._c_render_s = m.counter("server.render_s")
        self._c_dispatch_s = m.counter("server.dispatch_s")
        self._c_block_s = m.counter("server.block_s")
        self._render_calls = m.counter("server.render_calls")
        self._latency_ms = m.histogram("server.latency_ms")
        self._batch_sizes = m.histogram("server.batch_size", DEFAULT_SIZE_BUCKETS)
        self._occupancy = m.histogram("server.occupancy", DEFAULT_SIZE_BUCKETS)
        # ---- tile-path metrics (frame-granular; the cache's own hit/miss
        # counters are per-TILE once tile_cache is on)
        self._full_hits = m.counter("server.full_hits")        # resolved at submit
        self._partial_hits = m.counter("server.partial_hits")  # missing rows render
        self._frame_misses = m.counter("server.frame_misses")  # full render
        self._rows_rendered = m.counter("server.rows_rendered_partial")
        self._render_rows = m.counter("server.render_rows")
        # ---- LOD metrics: per-level request/row tallies live in the shared
        # registry (dotted names) so level decisions show up in snapshot()
        # and traces; `level_requests` below keeps the historical list read.
        self._c_level_requests = tuple(
            m.counter(f"server.level_requests.l{lvl}") for lvl in range(n_levels)
        )
        self._c_lod_rows = tuple(
            m.counter(f"server.lod_rows.l{lvl}") for lvl in range(n_levels)
        )
        self._c_foveated = m.counter("server.foveated_requests")
        # window state the registry can't hold (distributions over dynamic
        # key sets, window timestamps) — cleared by the same reset() via hook
        self._busy_until = 0.0  # end of the last retired in-flight window
        self._timestep_requests: dict[int, int] = {}
        self._t_first: float | None = None
        self._t_last: float | None = None
        m.on_reset(self._reset_window_state)

    def _reset_window_state(self) -> None:
        """registry.reset() hook: clear the window state held outside it.
        (``_timestep_requests`` stays host-side because its key set — the
        timeline — is dynamic; the fixed-arity per-level tallies moved into
        the registry as ``server.level_requests.l*`` / ``server.lod_rows.l*``.)"""
        self._busy_until = 0.0
        self._timestep_requests = {}
        self._t_first = self._t_last = None

    # historical attribute reads, now backed by the shared registry
    @property
    def completed(self) -> int:
        return self._completed.value

    @property
    def deduped(self) -> int:
        return self._deduped.value

    @property
    def full_hits(self) -> int:
        return self._full_hits.value

    @property
    def partial_hits(self) -> int:
        return self._partial_hits.value

    @property
    def frame_misses(self) -> int:
        return self._frame_misses.value

    @property
    def rows_rendered(self) -> int:
        return self._rows_rendered.value

    @property
    def render_rows(self) -> int:
        return self._render_rows.value

    @property
    def level_requests(self) -> list[int]:
        """Per-level request tally (read-only view of the registry counters
        ``server.level_requests.l*``; the historical attribute shape)."""
        return [c.value for c in self._c_level_requests]

    # first-entry aliases — the pre-timeline (static scene) public surface;
    # properties so they track add_timestep() re-registering the first entry
    @property
    def pyramid(self) -> LODPyramid:
        return self._timeline[self._first_timestep].pyramid

    @property
    def _level_params(self) -> tuple[G.GaussianModel, ...]:
        return self._timeline[self._first_timestep].level_params

    @property
    def strip_traces(self) -> int:
        """Tile-row render variants built so far (the partial-hit path; one
        per (level, row), built lazily)."""
        return len(self._strip_renders)

    @property
    def in_flight(self) -> int:
        """Dispatched-but-not-retired micro-batches currently on the ring."""
        return len(self._ring)

    # --------------------------------------------------------------- timeline
    def add_timestep(
        self, timestep: int, params: G.GaussianModel, *, changed=None, dirty_rows=None
    ) -> TimestepModels:
        """Register a model for one timeline position. Re-registering an
        existing timestep replaces the model AND invalidates its cached
        frames (stale frames must not outlive the model that rendered them).

        ``changed`` is the in situ fast path and needs **no caller-side row
        math**: pass the indices of the Gaussian slots the update rewrote
        (or ``True`` to have the server diff old vs new parameters itself)
        and the server projects those Gaussians' conservative screen bounds
        — under the old *and* new parameters — through **every registered
        cached pose** to compute the dirty tile rows per pose. Only those
        tiles are dropped; clean tiles survive and the next request
        partial-renders just the dirty rows. Poses missing from the bounded
        registry (evicted) and non-tile-cache servers fall back to a full
        drop of the timestep, so ``changed`` is always safe to pass.

        ``dirty_rows`` is the legacy manual escape hatch (tile-cache servers
        only): an explicit iterable of screen tile-row indices to drop for
        every pose, for callers that computed the footprint themselves. The
        two are mutually exclusive; omitting both drops the whole timestep.
        """
        if changed is not None and dirty_rows is not None:
            raise ValueError("pass either changed= or dirty_rows=, not both")
        cache = getattr(self, "cache", None)  # absent during __init__'s first entry
        if cache is not None and int(timestep) in self._timeline:
            if dirty_rows is not None:
                self.invalidate(timestep, rows=dirty_rows)
            elif changed is not None:
                self._invalidate_changed(timestep, self._timeline[int(timestep)], params, changed)
            else:
                self.invalidate(timestep)
        pyramid = build_lod_pyramid(
            _host_model(params),
            n_levels=self.n_levels,
            keep_ratio=self.keep_ratio,
            pad_quantum=self.cfg.pad_quantum,
        )
        level_params = tuple(G.from_numpy(lvl, self.device) for lvl in pyramid.levels)
        entry = TimestepModels(pyramid, level_params)
        self._timeline[int(timestep)] = entry
        return entry

    def timesteps(self) -> list[int]:
        return sorted(self._timeline)

    # ----------------------------------------------------------- invalidation
    def add_invalidation_listener(self, cb) -> None:
        """Register ``cb(timestep, rows)`` to fire after any cache
        invalidation of that timeline position (model replacement or explicit
        ``invalidate``). ``rows`` is ``None`` for a whole-frame drop or the
        frozenset of dirty screen tile-rows for a partial one. The frontend
        uses this to reset per-stream delta-encode chains — row-granular
        resets re-key only the dirty tiles on the wire."""
        self._invalidation_listeners.append(cb)

    def _notify_invalidation(self, ts: int, rows: frozenset | None) -> None:
        for cb in self._invalidation_listeners:
            cb(ts, rows)

    def invalidate(self, timestep: int, *, rows=None) -> int:
        """Drop cached frames of ``timestep`` — all of them, or (tile-cache
        servers) only the tiles in screen tile-rows ``rows``. Returns the
        number of cache entries dropped. In-flight and partially-assembled
        work is drained first, so a stale render can never land after its
        invalidation. Passing ``rows`` on a ``tile_cache=False`` server
        raises: the whole-frame cache cannot honor a row-granular drop, and
        silently widening it to the full frame would hide the caller's wrong
        assumption about what stayed cached."""
        if rows is not None and not self.tile_cache:
            raise ValueError(
                "invalidate(rows=...) needs tile_cache=True — a whole-frame "
                "cache has no row-granular entries to drop; call "
                "invalidate(timestep) for the full drop"
            )
        self.flush()  # old-model batches/partials must not outlive the drop
        ts = int(timestep)
        if rows is None:
            n = self.cache.drop(lambda k: k[0] == ts)
            self._notify_invalidation(ts, None)
        else:
            # dirty tiles go, and so does every ASSEMBLED frame of the
            # timestep — a stitched frame contains its dirty rows
            rset = frozenset(int(r) for r in rows)
            n = self.cache.drop(
                lambda k: k[0] == ts
                and (k[-1] == ASSEMBLED or (k[-1] // self.tiles_x) in rset)
            )
            self._notify_invalidation(ts, rset)
        return n

    def _invalidate_changed(
        self, timestep: int, old_entry: TimestepModels, new_params: G.GaussianModel, changed
    ) -> int:
        """World-space invalidation: drop exactly the tiles the changed
        Gaussians can touch, computed per cached pose from their projected
        bounds under the old and new parameters (see ``serve_gs.footprint``).
        Falls back to a full drop whenever row math cannot be trusted: no
        tile cache, a capacity (shape) change, or no registered poses."""
        ts = int(timestep)
        old = old_entry.pyramid.levels[0]  # full model, host numpy leaves
        new = _host_model(new_params)
        if not self.tile_cache:
            return self.invalidate(ts)
        if any(np.asarray(getattr(old, f)).shape != np.asarray(getattr(new, f)).shape
               for f in old._fields):
            return self.invalidate(ts)  # capacity change: no per-slot diff exists
        idx = changed_indices(old, new) if changed is True else np.asarray(changed).reshape(-1)
        if idx.size == 0:
            return 0  # bit-identical re-registration: nothing can differ
        if not self._poses:
            return self.invalidate(ts)
        dirty = dirty_row_map(
            old, new, idx, self._poses,
            img_h=self.cfg.img_h, img_w=self.cfg.img_w, tile_h=self.tile_h,
        )
        return self._invalidate_per_pose(ts, dirty)

    def _invalidate_per_pose(self, timestep: int, dirty_map: dict) -> int:
        """Drop each cached pose's own dirty tile rows (``dirty_map``:
        pose signature -> frozenset of rows). Entries whose pose is not in
        the map (evicted from the registry) are dropped whole — conservative,
        never stale. Listeners get the across-pose union (``None`` if any
        pose was unknown, forcing full downstream resets)."""
        self.flush()
        ts = int(timestep)
        unknown_pose = False

        def doomed(k: tuple) -> bool:
            nonlocal unknown_pose
            if k[0] != ts:
                return False
            rows = dirty_map.get(tuple(k[4:-1]))
            if rows is None:
                unknown_pose = True
                return True
            if not rows:
                return False
            return k[-1] == ASSEMBLED or (k[-1] // self.tiles_x) in rows

        n = self.cache.drop(doomed)
        union: set[int] = set()
        for rows in dirty_map.values():
            union |= rows
        self._notify_invalidation(ts, None if unknown_pose else frozenset(union))
        return n

    def _entry(self, timestep: int) -> TimestepModels:
        try:
            return self._timeline[int(timestep)]
        except KeyError:
            raise KeyError(
                f"timestep {timestep} not on the timeline (have {self.timesteps()})"
            ) from None

    def warmup(self, buckets: tuple[int, ...] | None = None, *, timesteps=None) -> float:
        """Render every (level, bucket) variant once; returns seconds.

        Pays the cold-start costs (the kernel library build, the CUDA
        context, the caching allocator's first blocks) before the first
        client connects. Does not touch the serving metrics or the cache.
        """
        buckets = buckets or self.batcher.buckets
        t0 = _now()
        for ts in timesteps if timesteps is not None else [self.timesteps()[0]]:
            entry = self._entry(ts)
            cam = front_camera(entry.pyramid, img_h=self.cfg.img_h, img_w=self.cfg.img_w)
            for lvl, lp in enumerate(entry.level_params):
                for b in buckets:
                    self._level_render[lvl](lp, stack_cameras([cam] * b))
        self._sync()
        return _now() - t0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ admit
    def _note_pose(self, sig: tuple, cam: Camera) -> None:
        """Record a served pose in the bounded registry (LRU by use)."""
        if sig in self._poses:
            self._poses.move_to_end(sig)
            return
        self._poses[sig] = camera_to_numpy(cam)
        while len(self._poses) > self.pose_registry_cap:
            self._poses.popitem(last=False)

    def submit(
        self,
        cam: Camera,
        *,
        timestep: int = 0,
        client_id: int = -1,
        t_submit: float | None = None,
        request_id: int | None = None,
        gaze: tuple | None = None,
        budget_ms: float | None = None,
    ) -> FrameFuture:
        """Admit one camera request; returns its :class:`FrameFuture`.

        Cache hits resolve immediately (the frame is already on the host);
        requests matching an *in-flight* key attach to the existing future
        (one render serves every concurrent duplicate); everything else is
        queued for the next micro-batch.

        ``gaze`` (normalized ``(x, y)`` in [0, 1]) and/or ``budget_ms`` opt a
        request into **foveated per-tile LOD** on tile-cache servers: tile
        rows near the gaze render at the coverage level, peripheral rows one
        level coarser per row of distance, and ``budget_ms`` shrinks the
        sharp zone until the estimated render cost fits (calibrated by a
        running per-row cost estimate; best-effort, never a hard deadline).
        Mixed-level frames assemble from the same per-(tile, level) cache
        entries uniform frames use, so a foveated request reuses every
        already-rendered tile at its assigned level and strip-renders only
        the rest. On ``tile_cache=False`` servers the hints are ignored
        (whole-frame serving has a single level per frame).

        ``request_id`` carries an id minted upstream (the gateway mints at
        admit) so the span tree keeps one id end to end; in-process callers
        omit it and the request mints its own.
        """
        if self._closed:
            raise RuntimeError("RenderServer is closed")
        t = _now() if t_submit is None else t_submit
        if self._t_first is None:
            self._t_first = t
        entry = self._entry(timestep)
        n_lvl = len(entry.level_params)  # built pyramid depth (may be < n_levels)
        level = min(select_level(entry.pyramid, cam, img_w=self.cfg.img_w), n_lvl - 1)
        row_levels = row_keys = None
        if (gaze is not None or budget_ms is not None) and self.tile_cache and not self.cache.disabled:
            gaze_row = None
            if gaze is not None:
                gaze_row = min(max(int(float(gaze[1]) * self.tiles_y), 0), self.tiles_y - 1)
            budget_rows = None
            if budget_ms is not None and self._row_cost_ms:
                budget_rows = float(budget_ms) / self._row_cost_ms
            rl = select_level_map(
                entry.pyramid, cam, img_w=self.cfg.img_w, tiles_y=self.tiles_y,
                gaze_row=gaze_row, budget_rows=budget_rows,
                n_levels=n_lvl, keep_ratio=self.keep_ratio,
            )
            if len(set(rl)) == 1:
                level = rl[0]  # degenerate map: the uniform path serves it
            else:
                row_levels = rl
                level = min(rl)  # the sharpest level present (gaze rows)
        if row_levels is None:
            key = frame_key(
                cam, level, height=self.cfg.img_h, width=self.cfg.img_w,
                timestep=timestep, pose_quantum=self.pose_quantum,
            )
        else:
            # Mixed-level frame key: same layout as frame_key — (timestep,
            # <level slot>, h, w) + pose signature — with the level slot
            # holding the whole row-level map. Its ASSEMBLED entry caches the
            # stitched result; the per-tile entries live under the *uniform*
            # keys of each row's level, shared with uniform-level frames.
            sig = quantize_camera(cam, pose_quantum=self.pose_quantum)
            key = (int(timestep), ("fov",) + row_levels, self.cfg.img_h, self.cfg.img_w) + sig
            uniq = {
                lvl: frame_key(
                    cam, lvl, height=self.cfg.img_h, width=self.cfg.img_w,
                    timestep=timestep, pose_quantum=self.pose_quantum,
                )
                for lvl in set(row_levels)
            }
            row_keys = tuple(uniq[lvl] for lvl in row_levels)
        kw = {} if request_id is None else {"request_id": int(request_id)}
        req = RenderRequest(
            cam=cam, level=level, t_submit=t, client_id=client_id, cache_key=key,
            timestep=int(timestep), row_levels=row_levels, **kw,
        )
        self._c_level_requests[level].inc()
        if self.tile_cache:
            self._note_pose(tuple(key[4:]), cam)
            if row_levels is None:
                self._c_lod_rows[level].inc(self.tiles_y)
            else:
                self._c_foveated.inc()
                for lvl in row_levels:
                    self._c_lod_rows[lvl].inc()
        self._timestep_requests[int(timestep)] = self._timestep_requests.get(int(timestep), 0) + 1
        rec = self.obs.trace

        tiles = None
        if self.tile_cache and not self.cache.disabled:
            # fast path: the stitched frame itself is cached (zero-copy hit)
            frame = self.cache.get(tile_key(key, ASSEMBLED))
            if frame is not None:
                self._full_hits.inc()
                if rec:
                    rec.record(req.request_id, "submit", t, _now(),
                               outcome="full_hit", level=level, timestep=int(timestep))
                fut = FrameFuture(self, key, req)
                fut._resolve(frame)
                return fut
            tiles = [
                self.cache.get(tile_key(key if row_keys is None else row_keys[ti // self.tiles_x], ti))
                for ti in range(self.n_tiles)
            ]
            if all(t is not None for t in tiles):  # full hit: assemble once
                self._full_hits.inc()
                a0 = _now()
                frame = self._assemble(tiles)
                self.cache.put(tile_key(key, ASSEMBLED), frame, dedup=False)
                if rec:
                    a1 = _now()
                    rec.record(req.request_id, "submit", t, a0,
                               outcome="full_hit", level=level, timestep=int(timestep))
                    rec.record(req.request_id, "assemble", a0, a1, tiles=self.n_tiles)
                fut = FrameFuture(self, key, req)
                fut._resolve(frame)
                return fut
        else:
            frame = self.cache.get(key)
            if frame is not None:
                if rec:
                    rec.record(req.request_id, "submit", t, _now(),
                               outcome="cache_hit", level=level, timestep=int(timestep))
                fut = FrameFuture(self, key, req)
                fut._resolve(frame)
                return fut
        fut = self._pending.get(key)
        if fut is not None:  # identical pose already in flight: render once
            fut._attach(req)
            self._deduped.inc()
            if rec:
                rec.record(req.request_id, "submit", t, _now(),
                           outcome="dedup", primary=fut.request_id,
                           level=level, timestep=int(timestep))
            return fut
        fut = FrameFuture(self, key, req)
        req.future = fut
        self._pending[key] = fut
        if tiles is not None and (row_levels is not None or any(t is not None for t in tiles)):
            # partial hit: a dedicated job renders only the missing tile rows.
            # Mixed-level frames always take this path — the batcher's full-
            # frame renders are single-level, but the strip renderer already
            # knows how to fill each row at its own level.
            got = sum(1 for x in tiles if x is not None)
            if got:
                self._partial_hits.inc()
            else:
                self._frame_misses.inc()
            if rec:
                rec.record(req.request_id, "submit", t, _now(),
                           outcome="partial_hit" if got else "miss",
                           missing_tiles=self.n_tiles - got,
                           level=level, timestep=int(timestep),
                           foveated=row_levels is not None)
            self._partial.append(
                _PartialJob(req=req, fut=fut, tiles=tiles, row_levels=row_levels, row_keys=row_keys)
            )
        else:
            if self.tile_cache:
                self._frame_misses.inc()
            if rec:
                rec.record(req.request_id, "submit", t, _now(),
                           outcome="miss", level=level, timestep=int(timestep))
            self.batcher.submit(req)
        return fut

    # ------------------------------------------------------------- tile path
    def _assemble(self, tiles: list) -> np.ndarray:
        """Stitch the row-major tile grid back into one read-only frame.

        Pure memory movement over the very floats the render produced, so the
        assembled frame is bit-identical to the full-frame render it was
        split from (or would have been split from)."""
        th, tw = self.tile_h, self.tile_w
        # build into an owned buffer (no .base): the cache stores it as-is,
        # so the resolved frame and the ASSEMBLED cache entry are one object
        frame = np.empty((self.cfg.img_h, self.cfg.img_w, 3), dtype=tiles[0].dtype)
        frame.reshape(self.tiles_y, th, self.tiles_x, tw, 3)[:] = (
            np.stack(tiles)
            .reshape(self.tiles_y, self.tiles_x, th, tw, 3)
            .transpose(0, 2, 1, 3, 4)
        )
        frame.setflags(write=False)
        return frame

    def _cache_put_frame(self, key: tuple, frame: np.ndarray) -> None:
        """Store a retired frame: whole (baseline) or split into tiles."""
        if not self.tile_cache:
            self.cache.put(key, frame)
            return
        if self.cache.disabled:
            return
        th, tw = self.tile_h, self.tile_w
        for ti in range(self.n_tiles):
            ty, tx = divmod(ti, self.tiles_x)
            self.cache.put(
                tile_key(key, ti),
                frame[ty * th : (ty + 1) * th, tx * tw : (tx + 1) * tw],
            )
        # and the stitched frame itself: later full hits are zero-copy (no
        # extra buffer here — this IS the retired frame, shared read-only)
        self.cache.put(tile_key(key, ASSEMBLED), frame, dedup=False)

    def _strip_fn(self, level: int, row: int):
        """The single-view tile-row render for (level, row), built lazily."""
        fn = self._strip_renders.get((level, row))
        if fn is None:
            fn = make_tile_row_render(self._level_cfgs[level], row=row)
            self._strip_renders[(level, row)] = fn
        return fn

    def warmup_tiles(self, *, levels=None, rows=None, timesteps=None) -> float:
        """Render tile-row variants once (the partial-hit path); returns
        seconds."""
        assert self.tile_cache, "tile-row renders exist only with tile_cache"
        t0 = _now()
        for ts in timesteps if timesteps is not None else [self.timesteps()[0]]:
            entry = self._entry(ts)
            cam = front_camera(entry.pyramid, img_h=self.cfg.img_h, img_w=self.cfg.img_w)
            for lvl in levels if levels is not None else range(len(entry.level_params)):
                for row in rows if rows is not None else range(self.tiles_y):
                    self._strip_fn(lvl, row)(entry.level_params[lvl], cam)
        self._sync()
        return _now() - t0

    def _update_row_cost(self, cost_ms: float) -> None:
        """Fold one measurement into the level-0-row cost EWMA (the
        budget_ms calibration); measurements arrive already normalized to
        level-0 row units."""
        prev = self._row_cost_ms
        self._row_cost_ms = cost_ms if prev is None else 0.8 * prev + 0.2 * cost_ms

    def _run_partial(self, job: _PartialJob) -> int:
        """Render a partial hit's missing tile rows — each at its assigned
        level for foveated jobs — then assemble and resolve."""
        req = job.req
        entry = self._entry(req.timestep)
        cam = req.cam
        lvl_of = (lambda r: job.row_levels[r]) if job.row_levels is not None else (lambda r: req.level)
        key_of = (lambda r: job.row_keys[r]) if job.row_keys is not None else (lambda r: req.cache_key)
        missing = sorted(
            {ti // self.tiles_x for ti, t in enumerate(job.tiles) if t is None}
        )
        t0 = _now()
        # dispatch every missing row first (asynchronous launches), then wait
        launched = [
            (r, self._strip_fn(lvl_of(r), r)(entry.level_params[lvl_of(r)], cam))
            for r in missing
        ]
        self._c_dispatch_s.add(_now() - t0)
        for r, dev in launched:
            strip = dev.cpu().numpy()  # (tile_h, W, 3); waits for this strip
            for tx in range(self.tiles_x):
                ti = r * self.tiles_x + tx
                if job.tiles[ti] is None:
                    tile = np.ascontiguousarray(
                        strip[:, tx * self.tile_w : (tx + 1) * self.tile_w]
                    )
                    tile.setflags(write=False)
                    self.cache.put(tile_key(key_of(r), ti), tile)
                    job.tiles[ti] = tile
        now = _now()
        self._c_block_s.add(now - t0)
        self._c_render_s.add(now - max(t0, self._busy_until))
        self._busy_until = now
        self._rows_rendered.inc(len(missing))
        self._render_rows.inc(len(missing))
        if missing:
            units = sum(self.keep_ratio ** lvl_of(r) for r in missing)
            self._update_row_cost((now - t0) * 1e3 / units)
        rec = self.obs.trace
        if rec:
            rec.record(req.request_id, "render", t0, now,
                       partial=True, rows=len(missing), level=req.level,
                       foveated=job.row_levels is not None)
        frame = self._assemble(job.tiles)
        self.cache.put(tile_key(req.cache_key, ASSEMBLED), frame, dedup=False)
        if rec:
            rec.record(req.request_id, "assemble", now, _now(), tiles=self.n_tiles)
        fut = self._pending.pop(req.cache_key, None)
        if fut is not None:
            return fut._resolve(frame)
        self._complete(req, frame)  # pragma: no cover - defensive
        return 1

    # ------------------------------------------------------------------ serve
    def _dispatch_one(self) -> bool:
        """Launch the next micro-batch without blocking on its result."""
        mb: MicroBatch | None = self.batcher.next_batch()
        if mb is None:
            return False
        entry = self._entry(mb.timestep)
        t0 = _now()
        imgs = self._level_render[mb.level](entry.level_params[mb.level], mb.cams)
        ready = None
        if imgs.device.type == "cuda":
            # queue the device->host copy behind the render and mark its end;
            # nothing here waits for the device
            host = torch.empty(imgs.shape, dtype=imgs.dtype, pin_memory=True)
            host.copy_(imgs, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(imgs.device))
            imgs = host
        self._c_dispatch_s.add(_now() - t0)
        self._render_calls.inc()
        self._batch_sizes.observe(len(mb.requests))
        self._ring.append(_InFlight(mb, imgs, ready, t0))
        self._occupancy.observe(len(self._ring))
        return True

    def _retire_one(self) -> int:
        """Block on the oldest in-flight batch and deliver its frames."""
        inf = self._ring.popleft()
        t0 = _now()
        if inf.ready is not None:
            inf.ready.synchronize()
        imgs = inf.imgs.numpy()
        now = _now()
        self._c_block_s.add(now - t0)
        # render.total_s is the UNION of in-flight windows (device-busy wall):
        # overlapping batches must not double-count, or depth>=2 would report
        # more render seconds than wall-clock and look slower per frame
        self._c_render_s.add(now - max(inf.t_dispatch, self._busy_until))
        self._busy_until = now
        done = 0
        self._render_rows.inc(self.tiles_y * len(inf.mb.requests))
        units = self.tiles_y * (self.keep_ratio ** inf.mb.level) * len(inf.mb.requests)
        self._update_row_cost((now - inf.t_dispatch) * 1e3 / units)
        rec = self.obs.trace
        for i, req in enumerate(inf.mb.requests):
            frame = imgs[i].copy()  # own buffer: never pin the whole batch
            frame.setflags(write=False)  # shared with cache + deduped waiters
            if rec:
                r0 = _now()
            self._cache_put_frame(req.cache_key, frame)
            fut = self._pending.pop(req.cache_key, None)
            if fut is not None:
                done += fut._resolve(frame)
            else:  # pragma: no cover - defensive: request outside the table
                self._complete(req, frame)
                done += 1
            if rec:
                rec.record(req.request_id, "render", inf.t_dispatch, now,
                           batch=len(inf.mb.requests), bucket=inf.mb.bucket,
                           level=inf.mb.level, timestep=inf.mb.timestep)
                rec.record(req.request_id, "retire", r0, _now())
        return done

    def step(self) -> int:
        """Advance the pipeline one unit; returns requests completed.

        Partial-hit jobs (cheap, row-granular) run first; then the ring fills
        up to ``pipeline_depth`` dispatches and retires the oldest batch. At
        depth 1 with no partial jobs this is exactly the synchronous
        submit->render->block loop this server used to run.
        """
        if self._partial:
            return self._run_partial(self._partial.popleft())
        while len(self._ring) < self.pipeline_depth and self._dispatch_one():
            pass
        if self._ring:
            return self._retire_one()
        return 0

    def flush(self) -> int:
        """Complete every admitted-to-render unit of work — the dispatched
        in-flight ring AND queued partial-hit jobs — without dispatching new
        micro-batches; returns requests completed. Invalidation goes through
        here so no old-model tile can land after its drop."""
        done = 0
        while self._ring:
            done += self._retire_one()
        while self._partial:
            done += self._run_partial(self._partial.popleft())
        return done

    def run(self) -> int:
        """Drain the queue, partial jobs, and the ring; returns completed."""
        done = 0
        while self.batcher.pending or self._ring or self._partial:
            done += self.step()
        return done

    # -------------------------------------------------------------- lifecycle
    def close(self) -> int:
        """Shut the server down; returns how many queued requests were failed.

        Retires (i.e. completes) every dispatched in-flight batch, then fails
        the futures of requests still waiting in the batcher queue with a
        ``RuntimeError`` (their ``result()`` raises instead of spinning on a
        dead pipeline), drops the queue, and releases the retirement buffer.
        Idempotent; ``submit`` after close raises."""
        if self._closed:
            return 0
        self._closed = True
        self.flush()  # in-flight work (ring + partials) completes with frames
        failed = 0
        err = RuntimeError("RenderServer closed before this request rendered")
        for fut in self._pending.values():  # queued-but-never-dispatched only:
            fut._fail(err)                  # retired keys left _pending above
            failed += len(fut.requests)
        self._pending.clear()
        self.batcher.clear()
        self.frames.clear()
        return failed

    @property
    def closed(self) -> bool:
        return self._closed

    def __enter__(self) -> "RenderServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _advance(self) -> bool:
        """One pipeline unit on behalf of an awaited future; False if idle."""
        if self.batcher.pending or self._ring or self._partial:
            self.step()
            return True
        return False

    def reset_metrics(self) -> None:
        """Open a fresh measurement window (e.g. after warmup laps, before a
        benchmark lap) by resetting the WHOLE shared registry: this tier, the
        cache, and — when the stack shares one ``Obs`` — sessions, encoders,
        and the gateway, in one atomic call. Leaves structural state (cache
        contents, timeline, strip renders) untouched; requires an idle pipeline."""
        assert not self._ring and not self.batcher.pending and not self._partial, (
            "pipeline not idle"
        )
        self.obs.metrics.reset()

    def _complete(self, req: RenderRequest, frame: np.ndarray) -> None:
        now = _now()
        self._t_last = now
        self._latency_ms.observe((now - req.t_submit) * 1e3)
        self._completed.inc()
        if self.store_frames:
            self.frames[req.request_id] = frame
            while len(self.frames) > self.frames_capacity:
                self.frames.popitem(last=False)  # retire the oldest frame

    # ---------------------------------------------------------------- metrics
    def _cache_report(self) -> dict:
        """Frame-granular cache stats. With the tile cache on, the raw
        FrameCache counters are per-tile; the frame-level view (what fraction
        of *requests* were served without a full render) nests them under
        ``tiles``."""
        if not self.tile_cache:
            return self.cache.stats()
        total = self.full_hits + self.partial_hits + self.frame_misses
        return {
            "hits": self.full_hits,
            "partial_hits": self.partial_hits,
            "misses": self.frame_misses,
            "hit_rate": round(self.full_hits / total, 4) if total else 0.0,
            "tiles": self.cache.stats(),
        }

    def report(self) -> dict:
        wall = (self._t_last - self._t_first) if (self._t_first is not None and self._t_last) else 0.0
        lat = self._latency_ms
        return {
            "completed": self.completed,
            "wall_s": round(wall, 4),
            "frames_per_s": round(self.completed / wall, 2) if wall > 0 else float("inf"),
            "latency_ms": {
                "p50": round(lat.percentile(50), 3),
                "p95": round(lat.percentile(95), 3),
                "p99": round(lat.percentile(99), 3),
                "max": round(lat.vmax, 3) if lat.vmax is not None else 0.0,
            },
            "render": {
                "calls": self._render_calls.value,
                "total_s": round(self._c_render_s.value, 4),
                "mean_batch": round(self._batch_sizes.mean, 2),
            },
            "pipeline": {
                "depth": self.pipeline_depth,
                "deduped": self.deduped,
                "in_flight_now": len(self._ring),
                "max_in_flight": int(self._occupancy.vmax or 0),
                "mean_in_flight": round(self._occupancy.mean, 3),
                "dispatch_s": round(self._c_dispatch_s.value, 4),
                "block_s": round(self._c_block_s.value, 4),
            },
            "cache": self._cache_report(),
            "tiles": {
                "enabled": self.tile_cache,
                "grid": [self.tiles_y, self.tiles_x],
                "full_hits": self.full_hits,
                "partial_hits": self.partial_hits,
                "frame_misses": self.frame_misses,
                "rows_rendered_partial": self.rows_rendered,
                "render_rows": self.render_rows,
                # render work per served frame, in full-frame units: 1.0 =
                # every request fully rendered, 0 = pure cache. THE tile
                # economy metric — partial invalidation should pull it well
                # under the whole-frame baseline's miss rate.
                "renders_per_frame": round(
                    self.render_rows / (self.tiles_y * self.completed), 4
                )
                if self.completed
                else 0.0,
                "strip_traces": self.strip_traces,
            },
            "lod": {
                "live_counts": list(self.pyramid.live_counts),
                "padded_counts": [lvl.n for lvl in self.pyramid.levels],
                "requests_per_level": self.level_requests,
                # per-tile-row LOD assignment tallies (foveated serving):
                # rows_per_level counts every tile row a request *assigned*
                # to each level, uniform or mixed
                "rows_per_level": [c.value for c in self._c_lod_rows],
                "foveated_requests": self._c_foveated.value,
                "row_cost_ms": round(self._row_cost_ms, 4) if self._row_cost_ms else 0.0,
            },
            "timeline": {
                "timesteps": self.timesteps(),
                "live_counts": {t: list(e.pyramid.live_counts) for t, e in sorted(self._timeline.items())},
                "requests_per_timestep": {t: n for t, n in sorted(self._timestep_requests.items())},
            },
        }
