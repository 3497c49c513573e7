"""Lock-free ring-buffer span recorder + the canonical request-id mint.

A *span* is one stage of one request's life: ``(seq, rid, name, t0, t1,
meta)``. The recorder is a bounded ring written from whichever thread the
stage runs on (event loop, render executor, encode executor) without any
lock: a slot index is reserved with ``next()`` on an ``itertools.count`` —
atomic under the GIL — and the tuple is stored with a single list item
assignment. Readers (``drain``/``spans``) tolerate slots being overwritten
mid-read because each slot holds its own ``seq``; when the ring laps,
``dropped`` reports exactly how many spans were lost.

Disabled tracing must cost nothing on the hot path. ``NullRecorder`` is
*falsy*, so every instrumentation site is two bytecodes::

    rec = self.obs.trace
    if rec:
        rec.record(...)

No tuple is built, no call is made, no allocation happens when tracing is
off — verified by a tracemalloc test in ``tests/test_obs.py``.

``new_request_id()`` lives here because the request id is the join key of
the whole span tree: the gateway mints one at admit, the engine mints one
for in-process callers, and ``MicroBatcher`` uses the same counter for its
default ids, so an id means the same thing in every tier.
"""
from __future__ import annotations

import itertools

from repro_torch.obs.clock import now

__all__ = [
    "Span",
    "TraceRecorder",
    "NullRecorder",
    "NULL_RECORDER",
    "new_request_id",
    "STAGES",
    "TRAIN_STAGES",
    "LOOP_STAGES",
    "STEP_STAGES",
]

# Stage vocabulary, in pipeline order. Exporters use this order to lay out
# Perfetto lanes; the JSONL contract promises names come from this set (plus
# any future additions — consumers must ignore unknown names).
STAGES = (
    "admit",      # gateway accepted the request (instant; roots the tree)
    "coalesce",   # waited in the session queue for a dispatch wave
    "shed",       # dropped by backpressure — terminated span, tree ends here
    "submit",     # engine cache probe + enqueue (cache/dedup outcome in meta)
    "render",     # device render of the micro-batch this request rode in
    "retire",     # device->host fetch + future resolution
    "assemble",   # tile-cache strip patch + frame assembly
    "encode",     # wire encoding (raw/delta/tiles)
    "write",      # socket write
)

# Training-loop stage vocabulary, in train-step order. One request id is
# minted per stream timestep (or per GSTrainer.fit call), so a whole
# timestep's stages join into one span tree and render next to serving
# lanes on the same monotonic clock when training and serving share an Obs.
TRAIN_STAGES = (
    "extract",    # isosurface extraction from the volume timestep
    "reseed",     # dead-slot reseeding (the streaming densify stand-in)
    "batch",      # host-side view-batch assembly
    "dispatch",   # jitted step call (returns under async dispatch)
    "device",     # device compute, bounded by block_until_ready
    "densify",    # densify_and_rebalance round (static pipeline only)
    "eval",       # eval-view render + PSNR
    "ckpt",       # checkpoint / temporal-store handoff
    "serve",      # live RenderServer add_timestep handoff
    "fit",        # the whole optimization loop of one timestep (parent span)
    # the train step's own stages (the port's; obs/steptrace.py), children
    # of their step's "dispatch" span; per view unless marked per step
    "project",    # projection of the own shard (or all N, params3d)
    "gather",     # the splats' all-gather over the model axis (mesh only)
    "sort",       # depth sort
    "bin",        # per-tile front-most-K lists
    "raster",     # slab gather + compositor forward
    "loss",       # L1 + D-SSIM over the mesh (per step)
    "backward",   # torch.autograd.grad + densify statistics (per step)
    "vjp",        # the projection's plain-version VJP (autograd thread)
    "raster_bwd", # the compositor's backward (autograd thread)
    "reduce",     # the data-axis all-reduces (mesh only, per step)
    "adam",       # Adam + the statistics' accumulation (per step)
)

# The loop's stages, which the JAX package's vocabulary has too, and the
# step's own: exporters and the replay keep the loop's layout and results
# equal to the JAX package's, and give the step's stages lanes of their own.
STEP_STAGES = TRAIN_STAGES[TRAIN_STAGES.index("fit") + 1:]
LOOP_STAGES = TRAIN_STAGES[:len(TRAIN_STAGES) - len(STEP_STAGES)]

_request_ids = itertools.count(1)


def new_request_id() -> int:
    """Mint a process-unique request id (GIL-atomic, any thread)."""
    return next(_request_ids)


class Span:
    """Read-side view of one recorded span (the ring stores bare tuples)."""

    __slots__ = ("seq", "rid", "name", "t0", "t1", "meta")

    def __init__(self, seq, rid, name, t0, t1, meta):
        self.seq = seq
        self.rid = rid
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.meta = meta

    @property
    def dur(self) -> float:
        return self.t1 - self.t0

    def __repr__(self):  # pragma: no cover - debugging aid
        return (
            f"Span(rid={self.rid}, {self.name!r}, "
            f"{(self.t1 - self.t0) * 1e3:.3f}ms, meta={self.meta})"
        )


class TraceRecorder:
    """Bounded multi-producer span ring; truthy (cf. ``NullRecorder``).

    ``record`` is safe from any thread and never blocks: slot reservation is
    one atomic ``next()``, the write is one list item store. A reader that
    races a lapping writer may see a stale tuple, but never a torn one
    (tuples are immutable; the store is a single pointer swap).
    """

    __slots__ = ("capacity", "_ring", "_seq")

    def __init__(self, capacity: int = 65536):
        assert capacity >= 1
        self.capacity = capacity
        self._ring: list = [None] * capacity
        self._seq = itertools.count()

    def __bool__(self) -> bool:
        return True

    def record(self, rid: int, name: str, t0: float, t1: float | None = None, **meta) -> None:
        """Record one finished span. ``t1=None`` -> instant span at ``t0``."""
        seq = next(self._seq)  # atomic slot reservation
        self._ring[seq % self.capacity] = (
            seq, rid, name, t0, t0 if t1 is None else t1, meta,
        )

    def instant(self, rid: int, name: str, **meta) -> None:
        """Record a zero-duration marker stamped with the current time."""
        self.record(rid, name, now(), None, **meta)

    @property
    def recorded(self) -> int:
        """Total spans ever recorded (including overwritten ones)."""
        return self._recorded()

    def _recorded(self) -> int:
        # itertools.count exposes its next value via __reduce__ without
        # advancing: ("count", (next_value,)).
        return self._seq.__reduce__()[1][0]

    @property
    def dropped(self) -> int:
        """Spans lost to ring overwrite so far."""
        return max(0, self._recorded() - self.capacity)

    def spans(self) -> list[Span]:
        """Snapshot the ring's surviving spans in record order (non-destructive)."""
        got = [s for s in list(self._ring) if s is not None]
        got.sort(key=lambda s: s[0])
        return [Span(*s) for s in got]

    def drain(self) -> list[Span]:
        """Snapshot then clear the ring (drop accounting keeps running)."""
        out = self.spans()
        self._ring = [None] * self.capacity
        return out


class NullRecorder:
    """The disabled recorder: falsy, so hot paths skip their whole
    instrumentation block — no meta dict, no time reads, no call."""

    __slots__ = ()
    capacity = 0

    def __bool__(self) -> bool:
        return False

    def record(self, *a, **kw) -> None:  # pragma: no cover - never on hot path
        pass

    def instant(self, *a, **kw) -> None:  # pragma: no cover
        pass

    @property
    def recorded(self) -> int:
        return 0

    @property
    def dropped(self) -> int:
        return 0

    def spans(self) -> list:
        return []

    def drain(self) -> list:
        return []


NULL_RECORDER = NullRecorder()
