"""Dynamic concurrency checks: tracked locks and the ref-leak sentinel.

This is the runtime half of ``repro_torch.analysis``. The static linter can
only see lock acquisitions the AST spells out; this module records the
*actual* acquisition-order graph while code runs, so the test suite
itself becomes the witness that the hierarchy documented in ``ORDER.md``
holds.

Everything here is **off by default**. Every lock-owning module in the
runtime creates its locks through the :func:`make_lock` /
:func:`make_rlock` seam; with ``REPRO_ANALYSIS`` unset those return
plain ``threading.Lock``/``RLock`` objects (zero overhead beyond one
function call at construction). Set ``REPRO_ANALYSIS=1`` and the same
seam hands out :class:`TrackedLock` / :class:`TrackedRLock` instead,
which

* maintain a per-thread stack of held locks,
* record every ``held → acquiring`` edge in a process-wide graph,
* raise :class:`LockOrderViolation` the moment an acquisition would
  close a cycle in that graph (a potential deadlock — caught *before*
  the process actually deadlocks, because the check runs on the edge,
  not on the block), and
* raise when an acquisition inverts the canonical order from
  ``ORDER.md`` (``repro_torch.analysis.order``), even if no second thread has
  run the opposite interleaving yet.

``conftest.py`` exposes the same flag as a pytest plugin: a per-test
DeviceRef leak sentinel plus an end-of-session lock-graph summary, so
``REPRO_ANALYSIS=1 pytest`` gates every PR on "zero cycles, zero leaked
refs".

This module deliberately imports nothing from the rest of ``repro_torch`` —
it sits *below* every runtime module (they import the seam from here),
so it must stay dependency-free apart from the standard library and
``repro_torch.analysis.order``.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Tuple

from .order import LOCK_RANKS, rank_of

__all__ = [
    "LockOrderViolation",
    "TrackedLock",
    "TrackedRLock",
    "make_lock",
    "make_rlock",
    "analysis_enabled",
    "lock_order_graph",
    "lock_order_cycles",
    "same_name_nestings",
    "recorded_violations",
    "reset_lock_graph",
]


def analysis_enabled() -> bool:
    """True when ``REPRO_ANALYSIS`` requests dynamic tracking."""
    return os.environ.get("REPRO_ANALYSIS", "").strip().lower() not in (
        "", "0", "false", "off")


class LockOrderViolation(RuntimeError):
    """An acquisition that closes a cycle in the observed lock graph,
    inverts the canonical ``ORDER.md`` hierarchy, or re-enters a
    non-reentrant lock on the same thread."""


class _Graph:
    """Process-wide acquisition-order graph over lock *names*."""

    def __init__(self):
        self.lock = threading.Lock()
        # name -> {name -> first-seen site string}
        self.edges: Dict[str, Dict[str, str]] = {}
        # (name, name) nestings between *different instances of the same
        # name* — not ranked by ORDER.md, reported separately
        self.same_name: Dict[str, str] = {}
        # violations raised so far (kept for the pytest summary even if
        # the raising test swallowed the exception)
        self.violations: List[str] = []

    def add_edge(self, a: str, b: str, site: str) -> None:
        with self.lock:
            self.edges.setdefault(a, {}).setdefault(b, site)

    def would_cycle(self, a: str, b: str) -> Optional[List[str]]:
        """Path ``b →* a`` in the current graph (adding ``a → b`` would
        close it into a cycle); returns the path or None."""
        with self.lock:
            seen = set()
            stack: List[Tuple[str, List[str]]] = [(b, [b])]
            while stack:
                node, path = stack.pop()
                if node == a:
                    return path
                if node in seen:
                    continue
                seen.add(node)
                for nxt in self.edges.get(node, ()):
                    stack.append((nxt, path + [nxt]))
        return None

    def cycles(self) -> List[List[str]]:
        """Every elementary cycle reachable in the recorded graph
        (deduplicated by node set) — empty on a healthy run."""
        out: List[List[str]] = []
        seen_sets = set()
        with self.lock:
            edges = {a: list(bs) for a, bs in self.edges.items()}
        for start in edges:
            stack = [(start, [start])]
            while stack:
                node, path = stack.pop()
                for nxt in edges.get(node, ()):
                    if nxt == start:
                        key = frozenset(path)
                        if key not in seen_sets:
                            seen_sets.add(key)
                            out.append(path + [start])
                    elif nxt not in path:
                        stack.append((nxt, path + [nxt]))
        return out


_graph = _Graph()
_held = threading.local()   # per-thread list of [lock, count] entries


def _held_stack() -> List[list]:
    st = getattr(_held, "stack", None)
    if st is None:
        st = _held.stack = []
    return st


def lock_order_graph() -> Dict[str, Dict[str, str]]:
    """Snapshot of the observed ``held → acquired`` edges (name-keyed;
    the value is the first call site that recorded the edge)."""
    with _graph.lock:
        return {a: dict(bs) for a, bs in _graph.edges.items()}


def lock_order_cycles() -> List[List[str]]:
    """Cycles in the observed graph — the dynamic analogue of the
    static ``lock-order`` rule's report. Empty on a healthy run."""
    return _graph.cycles()


def same_name_nestings() -> Dict[str, str]:
    """Nestings between two different instances sharing one name (e.g.
    two per-actor ``ActorState`` locks) — legal only under a documented
    instance-level tie-break, so they are surfaced for review rather
    than failed."""
    with _graph.lock:
        return dict(_graph.same_name)


def recorded_violations() -> List[str]:
    """Messages of every LockOrderViolation raised so far (kept even if
    the caller swallowed the exception)."""
    with _graph.lock:
        return list(_graph.violations)


def reset_lock_graph() -> None:
    """Forget recorded edges/violations (test isolation)."""
    with _graph.lock:
        _graph.edges.clear()
        _graph.same_name.clear()
        _graph.violations.clear()


def _site() -> str:
    """A terse ``file:line`` for the acquisition site (first frame
    outside this module)."""
    import traceback
    for frame in reversed(traceback.extract_stack(limit=12)[:-2]):
        if not frame.filename.endswith("runtime.py"):
            return f"{os.path.basename(frame.filename)}:{frame.lineno}"
    return "?"


def _violation(msg: str) -> LockOrderViolation:
    with _graph.lock:
        _graph.violations.append(msg)
    return LockOrderViolation(msg)


class TrackedLock:
    """Drop-in ``threading.Lock`` that records acquisition order.

    ``name`` keys the process-wide graph and (when listed in
    ``ORDER.md``) the canonical-rank check. Cycle and rank checks run on
    the *edge* — i.e. while attempting the acquisition — so a potential
    deadlock raises instead of hanging.
    """

    _reentrant = False

    def __init__(self, name: str):
        self.name = name
        self._inner = self._make_inner()

    def _make_inner(self):
        return threading.Lock()

    # -- the checks -------------------------------------------------------
    def _check_before(self, blocking: bool) -> None:
        stack = _held_stack()
        for entry in stack:
            held = entry[0]
            if held is self:
                if not self._reentrant:
                    raise _violation(
                        f"lock {self.name!r} re-acquired by the thread "
                        f"already holding it (non-reentrant self-deadlock) "
                        f"at {_site()}")
                return   # reentrant re-acquire: no new edges
        if not stack:
            return
        held_top = stack[-1][0]
        if held_top is self:
            return
        a, b = held_top.name, self.name
        if a == b:
            # two different instances of the same named lock: not ranked,
            # recorded separately (see same_name_nestings)
            with _graph.lock:
                _graph.same_name.setdefault(a, _site())
            return
        rb = rank_of(b)
        if rb is not None:
            # Compare against the innermost rank across *all* held locks,
            # not just the top of stack — an unranked lock in between must
            # not mask an inversion (ranked -> unranked -> outer ranked).
            worst_name: Optional[str] = None
            worst_rank: Optional[int] = None
            for held_entry in stack:
                r = rank_of(held_entry[0].name)
                if r is not None and (worst_rank is None or r > worst_rank):
                    worst_name, worst_rank = held_entry[0].name, r
            if worst_rank is not None and rb < worst_rank:
                raise _violation(
                    f"canonical lock-order violation: acquiring {b!r} "
                    f"(rank {rb}) while holding {worst_name!r} "
                    f"(rank {worst_rank}) at {_site()} — ORDER.md says "
                    f"{b!r} is an outer lock and must be taken first")
        if blocking:
            path = _graph.would_cycle(a, b)
            if path is not None:
                raise _violation(
                    f"lock-order cycle: acquiring {b!r} while holding "
                    f"{a!r} at {_site()}, but the reverse order "
                    f"{' -> '.join(path)} -> {a!r} was already observed "
                    "— two threads interleaving these paths deadlock")
            # Non-blocking probes record their edge only on *success*
            # (see acquire()): a failed try-lock never blocks, so it must
            # not seed phantom edges that later read as cycles.
            _graph.add_edge(a, b, _site())

    def _on_acquired(self) -> None:
        stack = _held_stack()
        if stack and stack[-1][0] is self:
            stack[-1][1] += 1
        else:
            stack.append([self, 1])

    def _on_released(self) -> None:
        stack = _held_stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] is self:
                stack[i][1] -= 1
                if stack[i][1] <= 0:
                    del stack[i]
                return

    # -- lock protocol ----------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._check_before(blocking)
        got = self._inner.acquire(blocking, timeout)
        if got:
            if not blocking:
                # non-blocking probes (e.g. Condition._is_owned) record
                # their edge only on success, to keep probe noise out
                stack = _held_stack()
                if stack and stack[-1][0] is not self:
                    a, b = stack[-1][0].name, self.name
                    if a != b:
                        _graph.add_edge(a, b, _site())
            self._on_acquired()
        return got

    def release(self) -> None:
        self._inner.release()
        self._on_released()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        rank = rank_of(self.name)
        return (f"{type(self).__name__}({self.name!r}, "
                f"rank={'unranked' if rank is None else rank})")


class TrackedRLock(TrackedLock):
    """Drop-in ``threading.RLock`` with the same tracking.

    Implements the private ``_release_save`` / ``_acquire_restore`` /
    ``_is_owned`` trio so ``threading.Condition`` waits correctly on a
    recursively held tracked lock (a plain release() would only pop one
    recursion level).
    """

    _reentrant = True

    def _make_inner(self):
        return threading.RLock()

    # -- Condition support -------------------------------------------------
    def _release_save(self):
        state = self._inner._release_save()
        stack = _held_stack()
        count = 0
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] is self:
                count = stack[i][1]
                del stack[i]
                break
        return (state, count)

    def _acquire_restore(self, saved):
        state, count = saved
        self._inner._acquire_restore(state)
        if count:
            _held_stack().append([self, count])

    def _is_owned(self):
        return self._inner._is_owned()


def make_lock(name: str):
    """The lock-constructor seam: a plain ``threading.Lock`` normally, a
    :class:`TrackedLock` under ``REPRO_ANALYSIS=1``. ``name`` should be
    the class-level lock name listed in ``ORDER.md`` (unlisted names are
    tracked for cycles but not ranked)."""
    if analysis_enabled():
        return TrackedLock(name)
    return threading.Lock()


def make_rlock(name: str):
    """Reentrant variant of :func:`make_lock`."""
    if analysis_enabled():
        return TrackedRLock(name)
    return threading.RLock()


# ----------------------------------------------------------------------------
# DeviceRef leak sentinel (driven by the pytest plugin in conftest.py)
# ----------------------------------------------------------------------------
def settled_ref_growth(before: int, *, timeout: float = 2.0,
                       poll: float = 0.02) -> int:
    """How many more DeviceRefs are live than ``before``, after giving
    garbage collection and in-flight actor callbacks ``timeout`` seconds
    to settle. Returns <= 0 when everything was reclaimed.

    Imports ``repro_torch.core.memref`` lazily so merely importing this module
    never pulls in torch.
    """
    import gc
    import time

    from repro_torch.core.memref import live_ref_count

    deadline = time.monotonic() + timeout
    growth = live_ref_count() - before
    while growth > 0 and time.monotonic() < deadline:
        gc.collect()
        growth = live_ref_count() - before
        if growth <= 0:
            break
        time.sleep(poll)  # lint: leak-sentinel settle poll, test-only path
    return growth
