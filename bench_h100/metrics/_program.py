"""What the readers of the program's own spans and counters share.

``repro_torch.trace`` records while a ``torch.profiler`` session runs, and
in a run only the traced window runs one, so every span and counter it
holds belongs to that window. A program without the tracer gives None,
and so does its reader."""
from __future__ import annotations

import statistics
from typing import List, Optional


def _trace():
    try:
        from repro_torch import trace
    except ImportError:
        return None
    return trace


def durations_s(name: str) -> Optional[List[float]]:
    """Seconds of each recorded span ``name``; None where there is none."""
    trace = _trace()
    if trace is None:
        return None
    out = [(s.end - s.start) / 1e9 for s in trace.spans() if s.name == name]
    return out or None


def median_s(name: str) -> Optional[float]:
    d = durations_s(name)
    return statistics.median(d) if d else None


def hops_s() -> Optional[List[float]]:
    """Seconds of each recorded ``actor.mailbox`` wait less what the
    receiving actor spent of it in earlier bodies (its ``actor.receive``
    spans, which never overlap): the hop's own latency, from the message's
    enqueue or the actor's last body, whichever ends later, to the start
    of its body. None where there is none."""
    trace = _trace()
    if trace is None:
        return None
    spans = trace.spans()
    bodies = {}
    for s in spans:
        if s.name == "actor.receive":
            bodies.setdefault(s.attrs.get("actor"), []).append(s)
    out = []
    for w in spans:
        if w.name == "actor.mailbox":
            busy = sum(max(0, min(b.end, w.end) - max(b.start, w.start))
                       for b in bodies.get(w.attrs.get("actor"), ()))
            out.append((w.end - w.start - busy) / 1e9)
    return out or None


def counter(name: str) -> Optional[int]:
    """The recorded counter ``name``; None where it was never counted."""
    trace = _trace()
    if trace is None:
        return None
    return trace.counters().get(name)
