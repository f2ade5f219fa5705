"""Spans and counters inside the port, on the profiler's clock.

An operator asks two questions of a running actor system: where a request
or a train step spends its host time, and why the card sits idle. This
module answers both from inside the program.

* :func:`span` (``with trace.span("stage"): ...``) records a named
  interval at a layer boundary; :func:`request` is a span that starts a
  new request or step. A span records its name, its ``attrs``, its start
  and end, the OS thread it ran on, its own id, its parent's id and the id
  of the request it belongs to. Spans of one request share that id across
  threads: an actor message carries it (:func:`stamp`, :func:`span_from`)
  and a remat recompute on the autograd engine's thread takes it from the
  forward's thread (:func:`here`, :func:`span_within`).
* :func:`count` adds to a named counter; device tensors are added on the
  device and read once, by :func:`counters`, which also reads the counters
  their owners already keep (:func:`reads`: kernel launches, the
  ``RefRegistry``'s host traffic, a graph's dispatch kinds) as their
  growth since the record began, and works out the counters that
  :func:`difference` names.
* :func:`device_time` adds a block's time on its device to a counter: on
  the card from two CUDA events on the current stream, which
  :func:`counters` reads.
* Recording is on inside :func:`recording`, or while a ``torch.profiler``
  session runs in the process. Off, :func:`span` returns one shared no-op
  object (:data:`NOOP`) after one flag check; a call site that builds
  attributes checks :func:`enabled` first and takes :data:`NOOP`, so that
  the off path builds no ``attrs`` either. Nothing here opens a ``record_function``
  range, an NVTX range or synchronises the card, so no span reaches the
  profiler's events or its device timeline.
* Times are ns on the Unix clock, which ``torch.profiler`` stamps its host
  events on and maps its device events onto: ``perf_counter_ns()`` plus
  one offset to ``time_ns()``, taken when this module loads and again when
  :func:`recording` starts. So :func:`idle_by_span` can put each idle gap
  of a profiler trace down to the program span the launching thread was
  in.

A record keeps at most ``max_spans`` spans, dropping the oldest and
counting the drops (:func:`dropped`).
"""
from __future__ import annotations

import contextlib
import itertools
import math
import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch.autograd.profiler as _profiler

__all__ = ["MAX_SPANS", "NOOP", "Span", "enabled", "span", "request",
           "current", "here", "span_within", "stamp", "span_from", "waited",
           "count", "device_time", "reads", "difference", "recording",
           "reset", "spans",
           "dropped", "counters", "summary", "profiled_gaps", "idle_by_span",
           "label_gaps"]

#: spans a record keeps before it drops the oldest
MAX_SPANS = 1 << 16

_ids = itertools.count(1)
_offset = time.time_ns() - time.perf_counter_ns()
_on = 0                      # open recording() blocks
_on_lock = threading.Lock()


def _now() -> int:
    return time.perf_counter_ns() + _offset


def enabled() -> bool:
    """Whether spans and counters are recorded now."""
    return _on > 0 or _profiler._is_profiler_enabled


#: a thread's pthread id cut to a signed 32-bit int -> its OS thread id:
#: the profiler names the thread of a runtime call either way
_aliases: Dict[int, int] = {}


def _int32(x: int) -> int:
    return ((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


class _Thread(threading.local):
    def __init__(self):
        self.stack: List["Span"] = []      # this thread's open spans
        self.tid = threading.get_native_id()
        _aliases[_int32(threading.get_ident())] = self.tid


_thread = _Thread()


class Span:
    """One interval: ``name``, ``attrs``, ``start`` and ``end`` (ns on the
    profiler's clock), ``thread`` (the OS thread id, as the profiler gives
    a runtime call's thread), ``id``, ``parent`` (the id of the span it ran
    under, None at the top), ``rid`` (the id of its request or step, None
    outside one) and ``wait`` (True for a span that records a wait, such as
    ``actor.mailbox``, not work its thread did)."""

    __slots__ = ("name", "attrs", "start", "end", "thread", "id", "parent",
                 "rid", "wait", "_under")

    def __init__(self, name: str, attrs: Dict[str, Any], under: Any = None):
        self.name = name
        self.attrs = attrs
        #: what the span opens under: None (this thread's innermost open
        #: span), _MINT (that, with a new request id), a stamp (its parent
        #: and request) or a thread's stack (its innermost open span)
        self._under = under
        self.wait = False

    def __enter__(self) -> "Span":
        t = _thread
        under = self._under
        self.id = next(_ids)
        if under is None or under is _MINT or type(under) is list:
            stack = t.stack if under is None or under is _MINT else under
            top = stack[-1] if stack else None
            self.parent = top.id if top is not None else None
            self.rid = top.rid if top is not None else None
            if under is _MINT:
                self.rid = self.id
        else:
            _, self.rid, self.parent = under
        self.thread = t.tid
        t.stack.append(self)
        self.start = _now()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = _now()
        stack = _thread.stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        _record.add(self)
        return False

    def __repr__(self):
        return (f"Span({self.name!r}, {self.attrs}, id={self.id}, "
                f"parent={self.parent}, rid={self.rid})")


class _Noop:
    """The span :func:`span` returns while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


#: the span :func:`span` returns while recording is off
NOOP = _Noop()
_MINT = object()


def span(name: str, **attrs: Any):
    """A span named ``name`` under this thread's innermost open span."""
    if not (_on > 0 or _profiler._is_profiler_enabled):
        return NOOP
    return Span(name, attrs)


def request(name: str, **attrs: Any):
    """A span that starts a request or a step: its id is the request id
    of every span under it, on any thread its messages reach."""
    if not (_on > 0 or _profiler._is_profiler_enabled):
        return NOOP
    return Span(name, attrs, _MINT)


def current() -> Optional[Span]:
    """This thread's innermost open span, or None (also while off)."""
    if not enabled():
        return None
    stack = _thread.stack
    return stack[-1] if stack else None


def here() -> List[Span]:
    """A handle on this thread's open spans, for :func:`span_within`."""
    return _thread.stack


def span_within(handle: List[Span], name: str, **attrs: Any):
    """A span on this thread under the innermost span open, when it
    enters, on the thread of ``handle`` (:func:`here`): a remat recompute
    that the autograd engine runs on its own thread while the step's
    thread waits in ``train.backward``."""
    if not enabled():
        return NOOP
    return Span(name, attrs, handle)


def stamp() -> Optional[Tuple[int, Optional[int], Optional[int]]]:
    """``(now, request id, parent id)`` of this thread's innermost open
    span, for a message to carry to another thread; None while off."""
    if not (_on > 0 or _profiler._is_profiler_enabled):
        return None
    stack = _thread.stack
    top = stack[-1] if stack else None
    if top is None:
        return _now(), None, None
    return _now(), top.rid, top.id


def span_from(st, name: str, **attrs: Any):
    """A span on this thread whose parent and request are those of the
    stamp ``st`` (:func:`stamp`), taken on the thread that sent the work."""
    if st is None or not enabled():
        return NOOP
    return Span(name, attrs, st)


def waited(st, name: str, **attrs: Any) -> None:
    """Record ``name``, a wait on this thread from the stamp ``st`` to
    now, under the stamp's parent and request."""
    if st is None or not enabled():
        return
    sp = Span(name, attrs, st)
    sp.id = next(_ids)
    sp.start, sp.rid, sp.parent = st
    sp.thread = _thread.tid
    sp.wait = True
    sp.end = _now()
    _record.add(sp)


# ----------------------------------------------------------------------------
# the record
# ----------------------------------------------------------------------------
#: owner -> read(owner) -> {counter name: value}, as long as owner lives
_owners: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_owners_lock = threading.Lock()
#: counter -> (total, part): :func:`counters` gives it as total - part
_differences: Dict[str, Tuple[str, str]] = {}


def _owner_counts() -> List[Tuple[Any, Dict[str, int]]]:
    """Each live owner (:func:`reads`) and its counters, read now."""
    with _owners_lock:
        owners = list(_owners.items())
    return [(owner, read(owner)) for owner, read in owners]


class Record:
    """The spans of one recording, oldest first, at most ``max_spans``
    (``dropped`` counts those let go), its counters, and the owners'
    counters when it began (``base``)."""

    def __init__(self, max_spans: int = MAX_SPANS):
        self.spans: deque = deque(maxlen=max_spans)
        self.dropped = 0
        self.counts: Dict[str, Any] = {}
        #: (counter, start event, end event) of each :func:`device_time`
        self.timed: List[Tuple[str, Any, Any]] = []
        self._lock = threading.Lock()
        self.base: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary(
            _owner_counts())

    def add(self, sp: Span) -> None:
        with self._lock:
            if len(self.spans) == self.spans.maxlen:
                self.dropped += 1
            self.spans.append(sp)

    def count(self, name: str, n) -> None:
        with self._lock:
            old = self.counts.get(name)
            # a device count's first value is kept as it is: one add on
            # the device for each count after it
            self.counts[name] = n if old is None else old + n


_record = Record()


def count(name: str, n) -> None:
    """Add ``n`` (an int, or a 0-d tensor added on its device without a
    sync, and kept: nothing may write to it later) to the counter
    ``name``, while recording."""
    if enabled():
        _record.count(name, n)


class _DeviceTime:
    """The block's time on its device; see :func:`device_time`."""

    __slots__ = ("name", "cuda", "start")

    def __init__(self, name: str, cuda: bool):
        self.name, self.cuda = name, cuda

    def __enter__(self):
        if self.cuda:
            import torch
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if not self.cuda:
            _record.count(self.name, time.perf_counter_ns() - self.start)
            return False
        import torch
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        rec = _record
        with rec._lock:
            rec.timed.append((self.name, self.start, end))
        return False


def device_time(name: str, device):
    """Add to the counter ``name`` the ns that the block's work takes on
    ``device`` (a ``torch.device``), while recording. On a CUDA device that is the distance of
    two events on the current stream, one recorded on entry and one on
    exit (the work launched in the block and any gaps in it, wherever the
    host waited), with no sync: :func:`counters` reads them. On any other
    device, whose operations are done when they return, it is the host's
    time over the block. Off, :data:`NOOP`."""
    if not (_on > 0 or _profiler._is_profiler_enabled):
        return NOOP
    return _DeviceTime(name, device.type == "cuda")


def reads(owner: Any, read: Callable[[Any], Dict[str, int]]) -> None:
    """Let :func:`counters` read ``read(owner)``, counters the owner keeps
    itself, for as long as ``owner`` lives; values of one name from
    several owners are summed."""
    with _owners_lock:
        _owners[owner] = read


def difference(name: str, total: str, part: str) -> None:
    """Let :func:`counters` give ``name`` as the counter ``total`` less the
    counter ``part``, worked out when read rather than counted where it
    happens (on the device, that would cost an operation each time)."""
    _differences[name] = (total, part)


@contextlib.contextmanager
def recording(max_spans: int = MAX_SPANS):
    """Record inside the block, into a new record that it yields and that
    :func:`spans`, :func:`counters` and :func:`summary` read."""
    global _on, _offset, _record
    with _on_lock:
        _offset = time.time_ns() - time.perf_counter_ns()
        _record = rec = Record(max_spans)
        _on += 1
    try:
        yield rec
    finally:
        with _on_lock:
            _on -= 1


def reset() -> None:
    """Start a new, empty record (spans recorded under a profiler session
    go to the newest record, and the owners' counters count from here)."""
    global _record
    _record = Record()


def spans() -> List[Span]:
    """The newest record's spans, oldest first."""
    rec = _record
    with rec._lock:
        return list(rec.spans)


def dropped() -> int:
    """Spans the newest record let go when it was full."""
    return _record.dropped


def counters() -> Dict[str, int]:
    """The newest record's counters (a device counter and the events of
    :func:`device_time` are read here, once),
    those that :func:`difference` names, and what the counters registered
    with :func:`reads` grew by since the record began (an owner made
    later counts from its start)."""
    rec = _record
    with rec._lock:
        counts = list(rec.counts.items())
        timed = list(rec.timed)
    out = {k: int(v) for k, v in counts}
    for name, start, end in timed:
        end.synchronize()
        out[name] = out.get(name, 0) + int(start.elapsed_time(end) * 1e6)
    for name, (total, part) in _differences.items():
        if total in out:
            out[name] = out[total] - out.get(part, 0)
    for owner, now in _owner_counts():
        base = rec.base.get(owner, {})
        for k, v in now.items():
            out[k] = out.get(k, 0) + int(v) - int(base.get(k, 0))
    return out


def _quantile(ordered: List[float], q: float) -> float:
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)]


def _covered(lo: int, hi: int, intervals: Iterable[Tuple[int, int]]) -> int:
    """ns of [lo, hi] that the union of ``intervals`` covers."""
    total, reach = 0, lo
    for s, e in sorted(intervals):
        s, e = max(s, reach), min(e, hi)
        if e > s:
            total += e - s
            reach = e
    return total


def summary(of: Optional[List[Span]] = None) -> Dict[str, Dict[str, float]]:
    """For each span name (of ``of``, else the newest record's spans):
    ``count``, ``total_s``, ``self_s`` (its durations less what its child
    spans, on any thread, cover of them), ``p50_s`` and ``p99_s``."""
    of = spans() if of is None else of
    children: Dict[int, List[Tuple[int, int]]] = {}
    for sp in of:
        if sp.parent is not None:
            children.setdefault(sp.parent, []).append((sp.start, sp.end))
    by: Dict[str, List[Tuple[int, int]]] = {}
    for sp in of:
        own = sp.end - sp.start
        kids = children.get(sp.id)
        by.setdefault(sp.name, []).append(
            (own, own - _covered(sp.start, sp.end, kids) if kids else own))
    out = {}
    for name, rows in by.items():
        ordered = sorted(d for d, _ in rows)
        out[name] = {"count": len(rows), "total_s": sum(ordered) / 1e9,
                     "self_s": sum(s for _, s in rows) / 1e9,
                     "p50_s": _quantile(ordered, 0.5) / 1e9,
                     "p99_s": _quantile(ordered, 0.99) / 1e9}
    return out


# ----------------------------------------------------------------------------
# the card's idle gaps, put down to program spans
# ----------------------------------------------------------------------------
def profiled_gaps(prof) -> List[Tuple[str, int, float]]:
    """The card's idle gaps in the finished ``torch.profiler.profile``
    ``prof``, in time order, each ``(label, start ns, seconds)``, labelled
    by the newest record's program span that held up the next launch: see
    :func:`label_gaps`. The card's work is what a CUDA runtime or
    driver call (a host event named ``cu...``) launched: kernels, copies
    and sets, not the profiler's annotations of host ranges (whose ids
    are of another count and may equal a launch's). The profiler
    names a call's thread by its OS id, or, on a thread it did not see
    start, by its pthread id cut to 32 bits: both map to the OS id."""
    from torch.autograd import DeviceType
    device: List[Tuple[int, int, int]] = []
    launches: Dict[int, Tuple[int, int, int]] = {}
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((start, start + e.duration_ns(),
                               e.correlation_id()))
        elif e.name().startswith("cu"):
            tid = e.device_resource_id()
            launches[e.correlation_id()] = (start, start + e.duration_ns(),
                                            _aliases.get(tid, tid))
    work = [d for d in device if d[2] in launches]
    return label_gaps(work, launches, spans())


def idle_by_span(prof) -> Dict[str, float]:
    """Idle seconds of the card in the finished ``torch.profiler.profile``
    ``prof`` by label (:func:`profiled_gaps`), the largest first: what the
    thread that fed the card next was doing while the card waited."""
    out: Dict[str, float] = {}
    for label, _, gap in profiled_gaps(prof):
        out[label] = out.get(label, 0.0) + gap
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def label_gaps(device: List[Tuple[int, int, int]],
               launches: Dict[int, Tuple[int, int, int]],
               of: List[Span]) -> List[Tuple[str, int, float]]:
    """The gaps between the card's work, in time order, each as ``(label,
    start ns, seconds)``. ``device`` holds ``(start ns, end ns,
    correlation id)`` of each kernel, copy or set; ``launches`` maps a correlation id to
    ``(start ns, end ns, OS thread id)`` of the runtime call that launched
    it. A gap of the union of ``device`` is labelled with the innermost
    span of ``of`` (waits left out) open at the gap's start on the thread
    that launched the work after it; ``none`` where no span was open
    there, ``not_host`` where that launch had returned before the gap
    began, ``unlinked`` where no launch is known."""
    merged: List[List[int]] = []
    for s, e, c in sorted(device):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e, c])
    out: List[Tuple[str, int, float]] = []
    # one sweep over time: closes (0) before opens (1) before gaps (2)
    events: List[Tuple[int, int, int, Any]] = []
    for (_, e0, _), (s1, _, c1) in zip(merged, merged[1:]):
        gap = (s1 - e0) / 1e9
        launch = launches.get(c1)
        if launch is None:
            label = "unlinked"
        elif launch[1] <= e0:
            label = "not_host"
        else:
            label = None
        out.append((label, e0, gap))
        if label is None:
            events.append((e0, 2, len(out) - 1, launch[2]))
    for sp in of:
        if not sp.wait:
            events.append((sp.start, 1, sp.id, sp))
            events.append((sp.end, 0, sp.id, sp))
    events.sort(key=lambda ev: ev[:3])
    open_on: Dict[int, List[Span]] = {}
    for _, kind, i, x in events:
        if kind == 1:
            open_on.setdefault(x.thread, []).append(x)
        elif kind == 0:
            stack = open_on[x.thread]
            if stack[-1] is x:
                stack.pop()
            else:
                stack.remove(x)
        else:
            stack = open_on.get(x)
            out[i] = (stack[-1].name if stack else "none",) + out[i][1:]
    return out
