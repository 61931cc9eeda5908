"""Lock-discipline checking — the reference's thread-safety-annotation
analogue (Clang ``GUARDED_BY``/``REQUIRES`` + ``WorldStateLock`` capability
types: shared/WorldStateLock.h, WorldState.h:44-63, PhysicsWorld.h:195-198).

C++ gets these checks at compile time; Python has no static checker, so this
is the dynamic equivalent (a TSan-lite for the host threading):

- ``CheckedRLock`` — an RLock that knows which thread holds it.
- ``guard(container, lock, name)`` — wraps a dict/set/list so EVERY access
  asserts the lock is held by the calling thread, raising
  ``LockDisciplineError`` (with the container name and thread) otherwise.

Checks are enabled by ``SUBSTRATA_LOCK_CHECKS=1`` (tests/conftest.py enables
them suite-wide so any discipline regression fails loudly).  Disabled,
``CheckedRLock`` degrades to a plain ``threading.RLock`` and ``guard``
returns the raw container — zero steady-state overhead in production.

A copy of ``substrata_tpu/shared/guarded.py`` with the port's imports: importing
any module of the reference package loads jax, so the port keeps its own.
"""

from __future__ import annotations

import os
import threading


def checks_enabled() -> bool:
    return os.environ.get("SUBSTRATA_LOCK_CHECKS", "") not in ("", "0")


class LockDisciplineError(AssertionError):
    """A GUARDED_BY container was accessed without holding its lock."""


class CheckedRLock:
    """Re-entrant lock that tracks its owner for discipline checks.

    API-compatible with ``threading.RLock`` for ``with``/acquire/release.
    """

    __slots__ = ("_lock", "_owner", "_count", "name")

    def __init__(self, name: str = "lock"):
        self._lock = threading.RLock()
        self._owner: int | None = None
        self._count = 0
        self.name = name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            self._owner = threading.get_ident()
            self._count += 1
        return ok

    def release(self):
        self._count -= 1
        if self._count == 0:
            self._owner = None
        self._lock.release()

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()

    def held(self) -> bool:
        return self._owner == threading.get_ident()

    def check(self, what: str):
        if self._owner != threading.get_ident():
            raise LockDisciplineError(
                f"'{what}' is GUARDED_BY({self.name}) but was accessed by "
                f"thread {threading.current_thread().name!r} without "
                f"holding it")


def _wrap(base, method_name):
    orig = getattr(base, method_name)

    def method(self, *args, **kwargs):
        self._g_lock.check(self._g_name)
        return orig(self, *args, **kwargs)

    method.__name__ = method_name
    method.__qualname__ = method_name
    return method


def _guarded_class(base, methods):
    ns = {"__slots__": ("_g_lock", "_g_name")}
    for m in methods:
        ns[m] = _wrap(base, m)
    return type(f"Guarded{base.__name__.capitalize()}", (base,), ns)


_DICT_METHODS = (
    "__getitem__", "__setitem__", "__delitem__", "__contains__", "__iter__",
    "__len__", "get", "pop", "popitem", "setdefault", "update", "clear",
    "items", "keys", "values", "copy",
)
_SET_METHODS = (
    "__contains__", "__iter__", "__len__", "add", "discard", "remove",
    "pop", "clear", "update", "copy", "difference_update",
    "intersection_update", "symmetric_difference_update",
)
_LIST_METHODS = (
    "__getitem__", "__setitem__", "__delitem__", "__contains__", "__iter__",
    "__len__", "append", "extend", "pop", "remove", "insert", "clear",
    "copy", "sort", "index",
)

GuardedDict = _guarded_class(dict, _DICT_METHODS)
GuardedSet = _guarded_class(set, _SET_METHODS)
GuardedList = _guarded_class(list, _LIST_METHODS)

_GUARDED_BY_BASE = {dict: GuardedDict, set: GuardedSet, list: GuardedList}


def guard(container, lock, name: str):
    """GUARDED_BY(lock) for a dict/set/list.

    With checks disabled (the default) returns ``container`` unchanged.
    ``lock`` may be a plain RLock when checks are disabled; with checks
    enabled it must be a CheckedRLock.
    """
    if not checks_enabled():
        return container
    if not isinstance(lock, CheckedRLock):
        raise TypeError("guard() needs a CheckedRLock when checks are on")
    cls = _GUARDED_BY_BASE[type(container)]
    g = cls(container)
    g._g_lock = lock
    g._g_name = name
    return g


def make_lock(name: str = "lock"):
    """A CheckedRLock when checks are enabled, else a plain RLock (zero
    per-acquire bookkeeping in production)."""
    return CheckedRLock(name) if checks_enabled() else threading.RLock()
