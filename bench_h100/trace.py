"""The device trace of a traced run: ``torch.profiler`` over a steady
sub-window, reduced to busy time, device time by kernel name and the
longest idle gaps, each gap labelled by the benchmark's own host span
(``span``) that was open across it.

Busy time is the length of the union of the device intervals (kernels,
copies, sets), as ``chip_smoke.device_busy_ms`` takes it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

#: the prefix of the benchmark's host spans in the trace
SPAN_PREFIX = "bench."
#: characters of a kernel name kept in the breakdown
NAME_CHARS = 120


def span(name: str):
    """A host span of the benchmark (``submit``, ``wait``, ``read``,
    ``step``); a no-op cost when no profiler runs."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class DeviceTrace:
    """``with DeviceTrace() as t: ...`` profiles the block; then
    ``t.summary()`` reduces it (times in seconds)."""

    def __init__(self, device):
        self._prof = None
        self._cuda = torch.device(device).type == "cuda"

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self._cuda:
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._cuda:
            torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        return False

    def summary(self) -> Dict[str, object]:
        from torch.autograd import DeviceType
        events = self._prof.events()
        dev, spans = [], []
        for e in events:
            tr = e.time_range
            if e.name.startswith(SPAN_PREFIX):
                # a host span also shows on the device's timeline as an
                # annotation over its kernels; only the host's is a span
                if e.device_type != DeviceType.CUDA:
                    spans.append((e.name[len(SPAN_PREFIX):], tr.start / 1e6,
                                  tr.end / 1e6))
            elif e.device_type == DeviceType.CUDA:
                dev.append((e.name, tr.start / 1e6, tr.end / 1e6))
        return reduce(dev, spans)


def reduce(dev: List[Tuple[str, float, float]],
           spans: List[Tuple[str, float, float]]) -> Dict[str, object]:
    """Busy seconds, device seconds by name, and the idle gaps between
    device intervals with the innermost benchmark span open across each."""
    merged = union([(s, e) for _, s, e in dev])
    busy = sum(e - s for s, e in merged)
    by_name: Dict[str, float] = {}
    for name, s, e in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    gaps = []
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        mid = 0.5 * (e0 + s1)
        label = _label(spans, mid)
        gaps.append((label, s1 - e0))
    return {"busy_s": busy, "by_name": by_name, "gaps": gaps}


def _label(spans, t: float) -> str:
    best: Optional[Tuple[float, str]] = None
    for name, s, e in spans:
        if s <= t <= e and (best is None or e - s < best[0]):
            best = (e - s, name)
    return best[1] if best else "none"


def breakdown(summary: Dict[str, object], top: int = 10) -> Dict[str, list]:
    """The ``breakdown`` of a traced run's line: the device operations that
    took most time, and the longest idle gaps, grouped by label."""
    ops = sorted(summary["by_name"].items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(summary["gaps"], key=lambda g: -g[1])[:top]
    return {"device_ops": [[n[:NAME_CHARS], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}


def device_seconds(summary: Dict[str, object], substring: str) -> float:
    """Device seconds of the operations whose name holds ``substring``."""
    return sum(s for n, s in summary["by_name"].items() if substring in n)
