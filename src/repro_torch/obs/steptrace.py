"""Stage spans inside the train step, on the recorder's clock and the
profiler's.

``GSTrainer.fit`` hands each step its recorder, the fit call's request id
and the step index through one thread-local slot (:func:`in_step`). The
step's sites read it on the step's own thread, so a serving render on
another thread (in situ shares one ``Obs``) never lands in a step. Each site
is one :func:`record` context::

    with steptrace.record(tc, "project", i):
        ...

which, while the slot is set, records a span of the stage (a child of the
step's ``dispatch`` span, meta ``step`` and ``view``) on ``obs.clock.now``,
and, while a ``torch.profiler`` runs, opens the range ``gs.<stage>`` so that
the kernels the stage launches and the idle gaps that start inside it carry
the stage's name in the device trace. The range is gated on the profiler's
own flag, not on the recorder: a profiled step with tracing off still
names its stages.

The range is a plain profiler op (``_RecordFunctionFast``), to which the
profiler links the kernels launched inside it as it links an autograd
node's. ``torch.profiler.record_function`` would open a user annotation,
and with CUDA activity the profiler lays a copy of each annotation on the
device's timeline, spanning its kernels and the idle gaps between them:
a device trace read as the union of its device rows would count those gaps
as busy (on an H100, the one-card benchmark cell read 5.2% idle with them
against 20.8% without).

The autograd Functions keep their step's context on their ``ctx``
(:func:`pin`), so the backward's spans, recorded on the autograd thread,
join their step's tree.

Off (no slot, no profiler) a site costs one truthiness check, one flag read
and a no-op context, and allocates nothing (``tests/test_torch_train_trace.py``).
"""
from __future__ import annotations

import threading

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

from repro_torch.obs.clock import now
from repro_torch.obs.trace import STEP_STAGES

__all__ = ["StepTrace", "current", "in_step", "pin", "record", "UNPINNED", "RANGES"]

# the profiler range of each stage
RANGES = {s: f"gs.{s}" for s in STEP_STAGES}
# what a Function's ctx holds when its forward ran outside a traced step
UNPINNED = (None, None)


class StepTrace:
    """One traced step: the recorder, the fit call's rid, the step index
    and the view the step is on (set by the step's view loop)."""

    __slots__ = ("rec", "rid", "step", "view")

    def __init__(self, rec, rid: int, step: int):
        self.rec, self.rid, self.step, self.view = rec, rid, step, None


class _Slot(threading.local):
    ctx: StepTrace | None = None


_slot = _Slot()


def current() -> StepTrace | None:
    """This thread's traced step, or None."""
    return _slot.ctx


def pin() -> tuple:
    """``(StepTrace, view)`` of this thread's traced step, for a Function's
    ctx; :data:`UNPINNED` outside one."""
    tc = _slot.ctx
    return UNPINNED if tc is None else (tc, tc.view)


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Scope:
    __slots__ = ("ctx",)

    def __init__(self, ctx: StepTrace):
        self.ctx = ctx

    def __enter__(self):
        _slot.ctx = self.ctx
        return self.ctx

    def __exit__(self, *exc):
        _slot.ctx = None
        return False


def in_step(rec, rid: int, step: int):
    """The scope of one step of ``fit``: sets this thread's slot while the
    recorder ``rec`` is on; a no-op while it is off."""
    return _Scope(StepTrace(rec, rid, step)) if rec else _OFF


class _Stage:
    __slots__ = ("tc", "name", "view", "range", "t0")

    def __init__(self, tc, name, view):
        self.tc, self.name, self.view = tc, name, view
        self.range = _RecordFunctionFast(RANGES[name]) if _profiler._is_profiler_enabled else None

    def __enter__(self):
        if self.range is not None:
            self.range.__enter__()
        self.t0 = now()
        return self

    def __exit__(self, *exc):
        t1 = now()
        if self.range is not None:
            self.range.__exit__(*exc)
        tc = self.tc
        if tc is not None:
            if self.view is None:
                tc.rec.record(tc.rid, self.name, self.t0, t1, step=tc.step)
            else:
                tc.rec.record(tc.rid, self.name, self.t0, t1, step=tc.step, view=self.view)
        return False


def record(tc: StepTrace | None, stage: str, view: int | None = None):
    """The context of one stage site: a span of ``stage`` in ``tc``'s step
    (per view when ``view`` is given) and, while a profiler runs, the range
    ``gs.<stage>``. A no-op with neither."""
    if tc is None and not _profiler._is_profiler_enabled:
        return _OFF
    return _Stage(tc, stage, view)
