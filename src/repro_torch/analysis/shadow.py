"""Runtime shadow checker: instrumented locks enforcing the hierarchy.

Locks are created through :func:`make_lock` (and conditions through
:func:`make_condition`) with a canonical name from
``repro_torch.analysis.hierarchy``.  With ``REPRO_SHADOW_LOCKS`` unset
the factories return a plain ``threading.Lock`` / ``Condition``.  With
``REPRO_SHADOW_LOCKS=1`` they return wrappers that keep a per-thread
stack of held locks and raise ``LockHierarchyViolation`` on an
acquisition that does not move strictly down the hierarchy, on
re-entry of a non-reentrant lock, on wait / notify without the
condition held, and in :func:`assert_no_locks_held` on a hot read
path.  :func:`locks_required` marks functions whose contract is "the
caller already holds these locks" and checks it when shadowing is on.

The env var is read at each factory call, never at import, so tests can
flip it without reimporting.
"""

from __future__ import annotations

import functools
import os
import threading
from typing import List, Tuple

from repro_torch.analysis import hierarchy

ENV_FLAG = "REPRO_SHADOW_LOCKS"

_tls = threading.local()


class LockHierarchyViolation(AssertionError):
    """A runtime acquisition violated the declared lock hierarchy."""


def shadow_enabled() -> bool:
    """Read the gate env var now (never snapshotted at import)."""
    return os.environ.get(ENV_FLAG, "").strip().lower() in (
        "1", "true", "on", "yes")


def _held_stack() -> List[Tuple[str, int]]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def held_locks() -> Tuple[str, ...]:
    """Canonical names of shadow locks held by the calling thread."""
    return tuple(name for name, _ in _held_stack())


class _ShadowLock:
    """A lock that checks the hierarchy on acquisition."""

    def __init__(self, name: str, inner, reentrant: bool = False) -> None:
        if name not in hierarchy.RANKS:
            raise LockHierarchyViolation(
                f"lock name '{name}' is not declared in "
                f"repro_torch/analysis/hierarchy.py")
        self._name = name
        self._rank = hierarchy.RANKS[name]
        self._reentrant = reentrant
        self._inner = inner

    def _push(self) -> None:
        _held_stack().append((self._name, self._rank))

    def _pop(self) -> None:
        stack = _held_stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] == self._name:
                del stack[i]
                return

    def acquire(self, blocking: bool = True, timeout: float = -1):
        stack = _held_stack()
        if any(held == self._name for held, _ in stack):
            # held already: a reentrant lock, or a bounded (non-blocking
            # or timed) probe, which times out instead of deadlocking, is
            # taken again without a check of the order
            if not (self._reentrant or not blocking or timeout >= 0):
                raise LockHierarchyViolation(
                    f"re-entry of non-reentrant lock '{self._name}' "
                    f"(held: {[n for n, _ in stack]}): self-deadlock")
        else:
            for held, held_rank in stack:
                if held_rank >= self._rank:
                    raise LockHierarchyViolation(
                        f"acquiring '{self._name}' (rank {self._rank}) "
                        f"while holding '{held}' (rank {held_rank}) "
                        f"inverts the declared hierarchy "
                        f"(repro_torch/analysis/hierarchy.py); held: "
                        f"{[n for n, _ in stack]}")
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._push()
        return got

    def release(self) -> None:
        self._inner.release()
        self._pop()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()


class _ShadowCondition(_ShadowLock):
    """A ``threading.Condition`` whose wait / notify require it held;
    a wait leaves the held stack while the condition is released."""

    def _require_held(self, op: str) -> None:
        if not any(n == self._name for n, _ in _held_stack()):
            raise LockHierarchyViolation(
                f"'{self._name}.{op}()' called without holding the "
                f"condition")

    def wait(self, timeout=None):
        self._require_held("wait")
        self._pop()
        try:
            return self._inner.wait(timeout)
        finally:
            self._push()

    def wait_for(self, predicate, timeout=None):
        self._require_held("wait_for")
        self._pop()
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            self._push()

    def notify(self, n: int = 1) -> None:
        self._require_held("notify")
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._require_held("notify_all")
        self._inner.notify_all()


def make_lock(name: str):
    """A ``threading.Lock`` (shadow-wrapped when the env gate is on)."""
    if shadow_enabled():
        return _ShadowLock(name, threading.Lock())
    return threading.Lock()


def make_rlock(name: str):
    """A ``threading.RLock`` (shadow-wrapped when the env gate is on)."""
    if shadow_enabled():
        return _ShadowLock(name, threading.RLock(), reentrant=True)
    return threading.RLock()


def make_condition(name: str):
    """A ``threading.Condition`` over an RLock, so re-entry is legal
    (shadow-wrapped when the env gate is on)."""
    if shadow_enabled():
        return _ShadowCondition(name, threading.Condition(), reentrant=True)
    return threading.Condition()


def assert_no_locks_held(where: str) -> None:
    """Hot-path guard: no shadow lock may be held across a device call.

    No-op unless shadowing is on."""
    if not shadow_enabled():
        return
    held = held_locks()
    if held:
        raise LockHierarchyViolation(
            f"{where}: device dispatch entered while holding "
            f"{list(held)}; device latency under a lock convoys every "
            f"other thread")


def locks_required(*names: str):
    """Declare "the caller must already hold these locks": checked at
    each call when shadowing is on (``repro.analysis.lockorder`` also
    reads it as the function's held-set seed)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if shadow_enabled():
                held = set(held_locks())
                missing = [n for n in names if n not in held]
                if missing:
                    raise LockHierarchyViolation(
                        f"{fn.__qualname__} requires {missing} held "
                        f"(held: {sorted(held)})")
            return fn(*args, **kwargs)
        wrapper.__locks_required__ = tuple(names)
        return wrapper
    return deco
