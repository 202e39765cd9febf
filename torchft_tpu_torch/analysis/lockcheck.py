"""Runtime lock-order detector (``TORCHFT_TPU_LOCKCHECK=1``).

The port's instance of ``torchft_tpu/analysis/lockcheck.py`` (stdlib only;
the port imports nothing of the JAX package). The port's concurrency
surface — lane threads in the socket transport, bounded workers in
ddp/local_sgd, the checkpoint server's stager, the manager's executor,
futures chaining, the serving cohort's adopters — acquires a lot of locks, and the
deadlock-freedom argument is implicit in acquisition ORDER. This module
makes the order explicit: instrumented drop-ins for ``threading.Lock``
/ ``threading.RLock`` record, per thread, which lock *sites* are held
when another site is acquired, building a global acquisition-order
graph. A cycle in that graph (site A held while acquiring B somewhere,
B held while acquiring A somewhere else) is a latent deadlock even if
the two paths never interleaved in this run — that is the whole point
of order checking over deadlock *detection*.

Granularity is the lock's ALLOCATION SITE (``file:line`` of the
``threading.Lock()`` call), not the instance: per-instance locks of the
same class collapse to one node, which is what makes the graph finite
and the report readable. The cost is that nested acquisition of two
*instances* from one site (self-edges) cannot be ordered and is
skipped.

Usage:

* ``TORCHFT_TPU_LOCKCHECK=1`` before importing torchft_tpu_torch installs the
  patch process-wide (``maybe_install`` runs from the package root).
* Tests call :func:`install` / :func:`uninstall` explicitly.
* A detected cycle raises :class:`LockOrderError` in the acquiring
  thread (set ``TORCHFT_TPU_LOCKCHECK_RAISE=0`` to only record) and is
  always appended to :func:`cycles`; :func:`report` dumps the graph
  with one example stack per edge for the runbook's reading.
"""

from __future__ import annotations

import os
import threading
import traceback
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "LockOrderError",
    "Lock",
    "RLock",
    "install",
    "uninstall",
    "maybe_install",
    "installed",
    "reset",
    "report",
    "cycles",
]

ENV_VAR = "TORCHFT_TPU_LOCKCHECK"
ENV_RAISE = "TORCHFT_TPU_LOCKCHECK_RAISE"


class LockOrderError(RuntimeError):
    """Two lock sites are acquired in both orders somewhere in the
    process — a latent deadlock. The message carries the cycle and one
    example stack per edge."""


class _State:
    """Global acquisition-order graph + per-thread held stacks."""

    def __init__(self) -> None:
        self.mu = threading.Lock()  # a REAL lock, never instrumented
        # (held_site, acquired_site) -> example stack (list of str)
        self.edges: Dict[Tuple[str, str], List[str]] = {}
        self.cycles: List[Dict[str, Any]] = []
        self.tls = threading.local()

    def held(self) -> List[Any]:
        stack = getattr(self.tls, "stack", None)
        if stack is None:
            stack = []
            self.tls.stack = stack
        return stack


_state = _State()


def _caller_site() -> str:
    """file:line of the frame that allocated the lock, skipping this
    module and threading internals."""
    for frame in traceback.extract_stack()[::-1]:
        fn = frame.filename.replace("\\", "/")
        if fn.endswith("analysis/lockcheck.py"):
            continue
        if fn.endswith("threading.py"):
            continue
        return f"{os.path.basename(os.path.dirname(fn))}/" \
               f"{os.path.basename(fn)}:{frame.lineno}"
    return "<unknown>"


def _find_path(src: str, dst: str) -> Optional[List[str]]:
    """DFS over edges from src looking for dst (caller holds _state.mu)."""
    stack = [(src, [src])]
    seen = {src}
    adj: Dict[str, List[str]] = {}
    for a, b in _state.edges:
        adj.setdefault(a, []).append(b)
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        for nxt in adj.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _note_acquired(lock: "_InstrumentedBase", can_raise: bool = True
                   ) -> None:
    me = threading.get_ident()
    held = _state.held()
    # prune phantoms first: threading.Lock may legally be released by a
    # DIFFERENT thread (handoff patterns in instrumented stdlib code);
    # the releasing thread cannot reach our thread-local stack, so the
    # entry lingers here until its owner mark no longer matches
    if held:
        held[:] = [h for h in held if h._owner == me]
    # reentrant re-acquire of an instance this thread already holds
    # (RLock) adds no ordering information
    already = any(h is lock for h in held)
    new_cycles: List[Dict[str, Any]] = []
    if held and not already:
        with _state.mu:
            for h in held:
                if h.site == lock.site:
                    continue  # same-site instances cannot be ordered
                key = (h.site, lock.site)
                if key in _state.edges:
                    continue
                # would the REVERSE direction already be reachable?
                back = _find_path(lock.site, h.site)
                _state.edges[key] = traceback.format_stack()[-10:-2]
                if back is not None:
                    # record EVERY cycle this acquisition closes — one
                    # acquisition of C while holding [A, B] can close a
                    # C<->A and a distinct C<->B cycle, and the edges
                    # just inserted suppress re-detection forever
                    cyc = {
                        "cycle": [h.site] + back,
                        "new_edge": f"{key[0]} -> {key[1]}",
                        "stack": _state.edges[key],
                    }
                    _state.cycles.append(cyc)
                    new_cycles.append(cyc)
    lock._owner = me
    held.append(lock)
    if new_cycles and can_raise and os.environ.get(ENV_RAISE, "1") != "0":
        # Fail crisply WITHOUT leaking the lock: undo the acquisition
        # before raising, so a `with lock:` whose __enter__ raises does
        # not leave the inner lock held forever (__exit__ never runs)
        # and wedge every other thread.
        del held[-1]
        lock._owner = None
        lock._inner.release()
        raise LockOrderError(
            "lock-order cycle(s): " + "; ".join(
                " -> ".join(c["cycle"]) for c in new_cycles
            )
            + "\n(new edge(s) " + ", ".join(
                c["new_edge"] for c in new_cycles
            )
            + " close a path that already exists in the other "
            "direction; torchft_tpu_torch.analysis.lockcheck.report() has "
            "one example stack per edge)"
        )


_OWNER_UNKNOWN = object()


def _note_released(lock: "_InstrumentedBase", all_levels: bool = False,
                   prev_owner: Any = _OWNER_UNKNOWN) -> None:
    held = _state.held()
    for i in range(len(held) - 1, -1, -1):
        if held[i] is lock:
            del held[i]
            if not all_levels:
                break
    # Clear the owner mark ONLY when this thread no longer holds any
    # recursion level (an inner RLock release must not un-own the outer
    # level — the prune in _note_acquired would silently drop it and
    # lose every later ordering edge), and only if nobody re-acquired
    # since the caller snapshotted the owner (release() drops the inner
    # lock BEFORE this bookkeeping runs, so a fast re-acquirer's fresh
    # mark must not be clobbered).
    if not any(h is lock for h in held):
        if prev_owner is _OWNER_UNKNOWN or lock._owner == prev_owner:
            lock._owner = None


class _InstrumentedBase:
    _kind = "Lock"

    def __init__(self, name: Optional[str] = None) -> None:
        self._inner = _originals[self._kind]()
        self.site = name or _caller_site()
        self._owner: Optional[int] = None  # thread ident while held

    # -- the Lock protocol ----------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            _note_acquired(self)
        return got

    def release(self) -> None:
        prev = self._owner
        self._inner.release()
        _note_released(self, prev_owner=prev)

    def locked(self) -> bool:
        return self._inner.locked()

    def _at_fork_reinit(self) -> None:
        # stdlib machinery (concurrent.futures, threading) registers
        # this with os.register_at_fork; the child's held-stack is a
        # fresh thread-local, so only the inner lock needs the reset.
        self._inner._at_fork_reinit()

    def __getattr__(self, name: str):
        # forward any remaining inner-lock protocol (never _inner
        # itself: __getattr__ fires before __init__ set it on
        # pickling/copy paths, and that must not recurse)
        if name == "_inner":
            raise AttributeError(name)
        return getattr(self._inner, name)

    # Condition() protocol, provided on plain Locks too: a Condition
    # over an instrumented Lock must re-acquire through
    # _acquire_restore (record-only) rather than acquire() — a
    # LockOrderError raised mid-cv-wait would release the cv lock out
    # from under the enclosing `with cond:` and corrupt its state.

    def _release_save(self):
        prev = self._owner
        self._inner.release()
        _note_released(self, all_levels=True, prev_owner=prev)
        return None

    def _acquire_restore(self, state) -> None:
        self._inner.acquire()
        _note_acquired(self, can_raise=False)

    def _is_owned(self) -> bool:
        # CPython's own fallback probe for lock types without owner
        # tracking (threading.Condition._is_owned)
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<lockcheck.{type(self).__name__} {self.site}>"


class Lock(_InstrumentedBase):
    _kind = "Lock"


class RLock(_InstrumentedBase):
    _kind = "RLock"

    # Condition() support: delegate the RLock-specific protocol while
    # keeping the held-stack honest across a cv wait (wait() releases
    # the lock via _release_save and re-takes it via _acquire_restore).

    def _release_save(self):
        prev = self._owner
        state = self._inner._release_save()  # drops EVERY recursion level
        _note_released(self, all_levels=True, prev_owner=prev)
        return state

    def _acquire_restore(self, state) -> None:
        self._inner._acquire_restore(state)
        # record-only here: raising mid-Condition.wait re-acquire would
        # corrupt the cv's lock state worse than the cycle it reports
        _note_acquired(self, can_raise=False)

    def _is_owned(self) -> bool:
        return self._inner._is_owned()


_originals: Dict[str, Any] = {
    "Lock": threading.Lock,
    "RLock": threading.RLock,
}
_installed = False


def install() -> None:
    """Patch ``threading.Lock``/``threading.RLock`` with the
    instrumented versions. Locks created BEFORE install are invisible —
    install as early as possible (the package root does this when
    ``TORCHFT_TPU_LOCKCHECK=1``). ``threading.Condition()`` with no
    lock argument picks up the patched RLock automatically."""
    global _installed
    if _installed:
        return
    _originals["Lock"] = threading.Lock
    _originals["RLock"] = threading.RLock
    threading.Lock = Lock  # type: ignore[misc]
    threading.RLock = RLock  # type: ignore[misc]
    _installed = True


def uninstall() -> None:
    global _installed
    if not _installed:
        return
    threading.Lock = _originals["Lock"]  # type: ignore[misc]
    threading.RLock = _originals["RLock"]  # type: ignore[misc]
    _installed = False


def installed() -> bool:
    return _installed


def maybe_install() -> None:
    if os.environ.get(ENV_VAR, "0") == "1":
        install()


def reset() -> None:
    """Drop the recorded graph + cycles (test isolation)."""
    with _state.mu:
        _state.edges.clear()
        _state.cycles.clear()


def cycles() -> List[Dict[str, Any]]:
    with _state.mu:
        return list(_state.cycles)


def report() -> Dict[str, Any]:
    """The acquisition-order graph: ``edges`` as ``"A -> B"`` with one
    example stack each, plus every recorded cycle. The runbook
    (docs/operations.md) explains how to read it."""
    with _state.mu:
        return {
            "edges": {
                f"{a} -> {b}": stack
                for (a, b), stack in sorted(_state.edges.items())
            },
            "cycles": list(_state.cycles),
        }
