"""Debug-mode race detector (the port of ``windflow_tpu/analysis/
debug_concurrency.py``), switched on by ``WF_TPU_DEBUG_CONCURRENCY=1``.

The scheduler's shared mutable structures — the staging pool's slot
dict, the flight recorder's rings, a replica's inbox and its stats
record, a packed batch builder — are guarded by a lock or by a
single-consumer convention.  A convention broken (two threads draining
one replica, an edit touching ``StagingPool._slots`` outside its lock)
corrupts silently; under the flag it raises
:class:`ConcurrencyViolation` at once:

* **lock-held assertions** — :class:`DebugLock` records its owner and
  :class:`LockCheckedDict` / :class:`LockCheckedDeque` refuse a mutation
  by a thread that does not hold it (``StagingPool`` swaps them in);
* **entry guards** — :func:`enter` / :func:`exit_` (or
  :class:`entry_guard`) bracket single-consumer sections (a replica's
  drain and dispatch, a ring write, a stats sample, the builder's
  append and finish); a second thread entering raises with both sites.

With the flag off every site is one module-level flag check
(``if debug_concurrency.ENABLED``): no wrapper object, no lookup.  The
flag is read from the environment at import; :func:`set_enabled` flips
it for tests and embedders.
"""

from __future__ import annotations

import os
import threading
from collections import deque

from windflow_tpu_torch.basic import WindFlowError

#: the ONLY thing a hot path checks when the detector is off
ENABLED = bool(int(os.environ.get("WF_TPU_DEBUG_CONCURRENCY", "0")))


class ConcurrencyViolation(WindFlowError):
    """A cross-thread access broke a documented concurrency contract."""


def set_enabled(on: bool) -> None:
    """Flip the detector at runtime; clears the entry-guard table so
    stale bracket state cannot false-positive."""
    global ENABLED
    ENABLED = bool(on)
    _active.clear()


# -- entry guards (single-consumer critical sections) ------------------------

#: id(obj) -> (thread id, thread name, site) while a guarded section is
#: active.  Plain dict: whole-entry installs and compares are atomic.
_active: dict = {}


def enter(obj, site: str) -> None:
    """Enter a single-consumer section on ``obj``; a second thread
    entering while the first is inside raises with both sites."""
    me = threading.get_ident()
    cur = _active.get(id(obj))
    if cur is not None and cur[0] != me:
        raise ConcurrencyViolation(
            f"{site}: thread '{threading.current_thread().name}' entered "
            f"while thread '{cur[1]}' is inside {cur[2]} on the same "
            f"{type(obj).__name__} — this structure is single-consumer "
            "by construction (WF_TPU_DEBUG_CONCURRENCY)")
    _active[id(obj)] = (me, threading.current_thread().name, site)


def exit_(obj) -> None:
    """Leave a section entered with :func:`enter`."""
    _active.pop(id(obj), None)


class entry_guard:
    """``with entry_guard(obj, site):`` form of enter/exit_, exception
    safe (a raise inside leaves no stale entry)."""

    __slots__ = ("obj", "site")

    def __init__(self, obj, site: str) -> None:
        self.obj = obj
        self.site = site

    def __enter__(self) -> None:
        enter(self.obj, self.site)

    def __exit__(self, *exc) -> None:
        exit_(self.obj)


# -- lock-held assertions -----------------------------------------------------

class DebugLock:
    """A ``threading.Lock`` that records its owning thread, so guarded
    structures can assert that whoever mutates them holds it."""

    __slots__ = ("_lock", "_owner", "name")

    def __init__(self, name: str = "lock") -> None:
        self._lock = threading.Lock()
        self._owner = None
        self.name = name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._owner = threading.get_ident()
        return got

    def release(self) -> None:
        self._owner = None
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def held_by_current_thread(self) -> bool:
        return self._owner == threading.get_ident()

    def __enter__(self) -> "DebugLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def _unlocked(guard: DebugLock, what: str) -> ConcurrencyViolation:
    return ConcurrencyViolation(
        f"{what} mutated by thread '{threading.current_thread().name}' "
        f"without holding {guard.name} — take the lock around every "
        "mutation (WF_TPU_DEBUG_CONCURRENCY)")


class LockCheckedDict(dict):
    """A dict whose MUTATIONS assert that its :class:`DebugLock` is held
    by the mutating thread; reads stay unchecked (unlocked writes are
    what corrupts)."""

    def __init__(self, guard: DebugLock, what: str, *args, **kw) -> None:
        super().__init__(*args, **kw)
        self._guard = guard
        self._what = what

    def _check(self) -> None:
        if not self._guard.held_by_current_thread():
            raise _unlocked(self._guard, self._what)

    def __setitem__(self, k, v):
        self._check()
        return super().__setitem__(k, v)

    def __delitem__(self, k):
        self._check()
        return super().__delitem__(k)

    def setdefault(self, k, default=None):
        self._check()
        return super().setdefault(k, default)

    def pop(self, *a):
        self._check()
        return super().pop(*a)

    def popitem(self):
        self._check()
        return super().popitem()

    def update(self, *a, **kw):
        self._check()
        return super().update(*a, **kw)

    def clear(self):
        self._check()
        return super().clear()


class LockCheckedDeque(deque):
    """Deque counterpart of :class:`LockCheckedDict`: a dict read hands
    out the mutable slot deque, so its mutations are checked too."""

    def __init__(self, guard: DebugLock, what: str, *args) -> None:
        super().__init__(*args)
        self._guard = guard
        self._what = what

    def _check(self) -> None:
        if not self._guard.held_by_current_thread():
            raise _unlocked(self._guard, self._what)

    def append(self, x):
        self._check()
        return super().append(x)

    def appendleft(self, x):
        self._check()
        return super().appendleft(x)

    def extend(self, it):
        self._check()
        return super().extend(it)

    def pop(self):
        self._check()
        return super().pop()

    def popleft(self):
        self._check()
        return super().popleft()

    def remove(self, x):
        self._check()
        return super().remove(x)

    def clear(self):
        self._check()
        return super().clear()

    def __delitem__(self, i):
        self._check()
        return super().__delitem__(i)
