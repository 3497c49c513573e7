"""TSan-lite: opt-in runtime lockset race sanitizer (``REPRO_TSAN=1``), a
copy of the JAX package's ``analysis/tsan.py`` for the port's threaded
classes. The same variable switches both packages' copies on.

The static pass (the port's ``analysis/locks.py``, a copy of the JAX
package's) sees spelled-out ``self.x``
writes; it cannot see aliased mutation (``d = self._index; d["k"] = v``) or
prove a happens-before discipline actually holds at runtime. This module is
the dynamic complement: instances at the known thread boundaries (gateway,
session manager, checkpoint-store writer) opt in via :func:`attach`, which

* swaps the instance's class for a generated subclass whose ``__setattr__``
  records every field write with the writing thread + the locks it holds,
* wraps named lock attributes in :class:`TrackedLock` (maintains the
  per-thread held-lock set),
* wraps named dict attributes in :class:`TrackedDict` (mutator methods
  count as writes to the owning field — the aliasing the AST pass misses),

and runs the Eraser lockset state machine per field: a field stays
*exclusive* while one thread writes it; the second writing thread moves it
to *shared* and every shared write intersects the candidate lockset. An
empty intersection is a write/write race, recorded (once per field) on the
module-level :data:`RACES` list that the test fixture drains and fails on.

Fields whose cross-thread order is established by something other than a
lock (``queue.join()``, a ``threading.Event``) are listed in ``ordered=``
and exempted — the waiver mirror of the static pass's pragma.

When ``REPRO_TSAN`` is unset this module is inert: :func:`attach` returns
the instance untouched, no wrapper types are created, and instrumented
code paths are bitwise identical to an uninstrumented run.
"""
from __future__ import annotations

import dataclasses
import os
import threading

__all__ = [
    "enabled",
    "attach",
    "TrackedLock",
    "TrackedDict",
    "Race",
    "RACES",
    "take_races",
    "reset",
]

_TLS = threading.local()
_RACE_LOCK = threading.Lock()
RACES: list["Race"] = []
_SUBCLASS_CACHE: dict[type, type] = {}


def enabled() -> bool:
    return os.environ.get("REPRO_TSAN", "") not in ("", "0")


def _held() -> tuple[int, ...]:
    return tuple(getattr(_TLS, "held", ()))


def _push_held(lock_id: int) -> None:
    _TLS.held = _held() + (lock_id,)


def _pop_held(lock_id: int) -> None:
    held = list(_held())
    if lock_id in held:
        held.reverse()
        held.remove(lock_id)
        held.reverse()
    _TLS.held = tuple(held)


@dataclasses.dataclass
class Race:
    """One detected write/write race (reported once per (object, field))."""

    obj: str      # attach-time name, e.g. "SessionManager"
    field: str
    threads: tuple[str, str]  # (owner thread name, racing thread name)
    message: str

    def __str__(self) -> str:
        return self.message


@dataclasses.dataclass
class _FieldState:
    owner: int | None = None      # first writing thread ident
    owner_name: str = ""
    shared: bool = False
    lockset: frozenset | None = None
    reported: bool = False


class _Cfg:
    __slots__ = ("name", "exempt", "dicts", "fields", "lock")

    def __init__(self, name: str, exempt: set[str], dicts: set[str]):
        self.name = name
        self.exempt = exempt
        self.dicts = dicts
        self.fields: dict[str, _FieldState] = {}
        self.lock = threading.Lock()  # guards .fields itself


def _on_write(cfg: _Cfg, field: str) -> None:
    if field in cfg.exempt:
        return
    tid = threading.get_ident()
    tname = threading.current_thread().name
    with cfg.lock:
        st = cfg.fields.setdefault(field, _FieldState())
        if st.owner is None:
            st.owner, st.owner_name = tid, tname
            return
        if not st.shared:
            if tid == st.owner:
                return
            st.shared = True               # second writer arrives: Eraser
            st.lockset = frozenset(_held())  # candidate set = its locks
        else:
            st.lockset = st.lockset & frozenset(_held())
        if not st.lockset and not st.reported:
            st.reported = True
            race = Race(
                cfg.name, field, (st.owner_name, tname),
                f"write/write race on {cfg.name}.{field}: threads "
                f"{st.owner_name!r} and {tname!r} both write it with no "
                "common lock held — guard it, or attach() it as ordered= "
                "with the happens-before that protects it",
            )
            with _RACE_LOCK:
                RACES.append(race)


class TrackedLock:
    """Wraps a Lock/RLock; acquire/release maintain the held-lock set."""

    def __init__(self, lock, name: str):
        self._lock = lock
        self._name = name

    def acquire(self, *a, **kw) -> bool:
        got = self._lock.acquire(*a, **kw)
        if got:
            _push_held(id(self))
        return got

    def release(self) -> None:
        _pop_held(id(self))
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __repr__(self) -> str:
        return f"TrackedLock({self._name})"


class TrackedDict(dict):
    """dict whose mutators count as writes to the owning object's field —
    catches the ``d = self._index; d[k] = v`` aliasing the AST pass can't."""

    def __init__(self, data, cfg: _Cfg, field: str):
        super().__init__(data)
        self._cfg = cfg
        self._field = field

    def _w(self) -> None:
        _on_write(self._cfg, self._field)

    def __setitem__(self, k, v):
        self._w()
        super().__setitem__(k, v)

    def __delitem__(self, k):
        self._w()
        super().__delitem__(k)

    def pop(self, *a):
        self._w()
        return super().pop(*a)

    def popitem(self):
        self._w()
        return super().popitem()

    def clear(self):
        self._w()
        super().clear()

    def update(self, *a, **kw):
        self._w()
        super().update(*a, **kw)

    def setdefault(self, k, default=None):
        self._w()
        return super().setdefault(k, default)


def _tracked_setattr(self, name, value):
    cfg = self.__dict__.get("_tsan_cfg")
    if cfg is not None and not name.startswith("_tsan"):
        if name in cfg.dicts and type(value) is dict:
            # field re-assigned a plain dict (swap patterns like
            # ``dirty, self._d = self._d, {}``): keep tracking the new one
            value = TrackedDict(value, cfg, name)
        _on_write(cfg, name)  # checks the ordered/exempt set itself
    object.__setattr__(self, name, value)


def attach(obj, *, locks=(), dicts=(), ordered=(), name: str | None = None):
    """Instrument ``obj`` (in place) when the sanitizer is enabled.

    ``locks``: attribute names holding Lock/RLock objects — wrapped so the
    held-lock set is maintained. ``dicts``: dict-valued attributes whose
    mutator calls count as field writes. ``ordered``: fields exempted
    because a non-lock happens-before (queue.join, Event) orders them.
    Returns ``obj`` either way; a no-op (same object, same class, same
    attribute values) when ``REPRO_TSAN`` is off."""
    if not enabled():
        return obj
    cls = obj.__class__
    sub = _SUBCLASS_CACHE.get(cls)
    if sub is None:
        sub = type("Tsan" + cls.__name__, (cls,), {"__setattr__": _tracked_setattr})
        _SUBCLASS_CACHE[cls] = sub
    cfg = _Cfg(name or cls.__name__, set(ordered) | set(locks), set(dicts))
    object.__setattr__(obj, "_tsan_cfg", cfg)
    for ln in locks:
        object.__setattr__(obj, ln, TrackedLock(getattr(obj, ln), f"{cfg.name}.{ln}"))
    for dn in dicts:
        object.__setattr__(obj, dn, TrackedDict(getattr(obj, dn), cfg, dn))
    obj.__class__ = sub
    return obj


def take_races() -> list[Race]:
    """Drain and return the recorded races (the test-fixture hook)."""
    with _RACE_LOCK:
        out, RACES[:] = list(RACES), []
    return out


def reset() -> None:
    take_races()
