"""Why the card idles in a benchmark cell, by the program's own spans.

    python3 tools/idle_by_span.py --workload <cell> --seed <n> \
        [--seconds 10] [--rounds 2] [--out work/idle_by_span]

Sets one cell of ``BENCHMARK.json`` up as ``bench_h100/run.py`` does, with
``bench_h100``'s ``spec``, ``weights`` and runner classes, then:

1. **The cost of recording.** Runs the cell's window (``--seconds`` each)
   ``--rounds`` times with ``repro_torch.trace`` off and as often inside
   ``trace.recording()``, in turns (off, on; then on, off; ...), and
   reports each side's end-to-end metric and the change as a % of it,
   with the spans a request or step records. Times ``trace.span`` on this
   host too, off and on, as the program calls it: without attributes, and
   with them behind a ``trace.enabled()`` check.
2. **The traced window.** Profiles the same requests or steps the
   benchmark's traced window sends (the runner's ``traced()``), and prints
   ``trace.idle_by_span`` of that profile: the card's idle seconds by the
   program span the launching thread was in, the ten longest gaps with
   their labels and the garbage collector's pauses inside them, each
   request's or step's spans, the per-layer metrics of the cell (every
   reader of ``bench_h100/metrics/``), ``trace.summary()`` and
   ``trace.counters()``.

The last line of standard output is one JSON object with all of it, also
written to ``<out>/<cell>.json``. Needs the CUDA devices the cell asks
for; exits 2 without them.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (os.path.join(ROOT, "src"), ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def _span_cost_ns(n: int = 200_000) -> dict:
    """ns a ``with trace.span(...)`` takes on this host, off and on:
    ``bare`` without attributes, ``attrs`` with one behind a
    ``trace.enabled()`` check."""
    from repro_torch import trace

    def bare():
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with trace.span("cost"):
                pass
        return (time.perf_counter_ns() - t0) / n

    def attrs():
        t0 = time.perf_counter_ns()
        for i in range(n):
            with (trace.span("cost", index=i) if trace.enabled()
                  else trace.NOOP):
                pass
        return (time.perf_counter_ns() - t0) / n

    out = {"off_bare_ns": bare(), "off_attrs_ns": attrs()}
    with trace.recording(max_spans=16):
        out.update(on_bare_ns=bare(), on_attrs_ns=attrs())
    return out


def _cost(drv, metric: str, rounds: int, units: str) -> dict:
    """The window's end-to-end metric off and on, in turns."""
    from repro_torch import trace
    runs = {"off": [], "on": []}
    spans = []
    for r in range(rounds):
        for mode in (("off", "on") if r % 2 == 0 else ("on", "off")):
            if mode == "on":
                with trace.recording():
                    e2e = drv.window()
                done = len(getattr(drv, "counted", ())) or e2e["steps"]
                spans.append(len(trace.spans()) / done)
            else:
                e2e = drv.window()
            runs[mode].append(e2e[metric])
            print(f"cost {mode}: {metric} {e2e[metric]!r}", flush=True)
    off, on = statistics.median(runs["off"]), statistics.median(runs["on"])
    return {"metric": metric, "off": runs["off"], "on": runs["on"],
            "change_pct": 100.0 * (on - off) / off,
            f"spans_a_{units}": statistics.median(spans)}


def _by_label(gaps) -> dict:
    """Per label: the gaps' count, seconds, and those under 10 us."""
    out = {}
    for label, _, g in gaps:
        row = out.setdefault(label, {"count": 0, "s": 0.0, "under_10us": 0})
        row["count"] += 1
        row["s"] += g
        row["under_10us"] += g < 1e-5
    return out


def _longest(gaps, spans, pauses, n: int = 10) -> list:
    """The ``n`` longest gaps: label, ms, the attributes and thread of the
    labelling span, and the garbage collector's pauses (ms, generation)
    that overlap the gap."""
    out = []
    for label, t, g in sorted(gaps, key=lambda x: -x[2])[:n]:
        sp = max((s for s in spans if s.name == label and not s.wait
                  and s.start <= t < s.end), key=lambda s: s.start,
                 default=None)
        end = t + g * 1e9
        out.append({"label": label, "ms": g * 1e3,
                    "attrs": sp.attrs if sp else None,
                    "thread": sp.thread if sp else None,
                    "gc": [((min(e, end) - max(s, t)) / 1e6, gen)
                           for s, e, gen in pauses
                           if e is not None and s < end and e > t]})
    return out


def _requests(spans) -> list:
    """Per request or step, in order: seconds from its first span's start
    to its last span's end, and the seconds of each span name in it."""
    by = {}
    for s in spans:
        if s.rid is not None:
            by.setdefault(s.rid, []).append(s)
    out = []
    for rid in sorted(by):
        rows = by[rid]
        names = {}
        for s in rows:
            names[s.name] = names.get(s.name, 0.0) + (s.end - s.start) / 1e9
        out.append({"rid": rid, "s": (max(s.end for s in rows)
                                      - min(s.start for s in rows)) / 1e9,
                    "spans": names})
    return out


def run(workload: str, seed: int, seconds: float, rounds: int,
        device: str = "cuda:0", overrides=None) -> dict:
    """Everything the tool reports, for one cell; ``overrides(cell, cfg)
    -> (cell, cfg)`` replaces sizes (a rehearsal on the CPU)."""
    import torch
    from bench_h100 import harness, spec
    from bench_h100 import weights as weights_mod
    from bench_h100.metrics._program import hops_s
    from bench_h100.runners.common import sync
    from bench_h100.trace import DeviceTrace
    from repro_torch import trace
    from repro_torch.models import Model
    from repro_torch.models.layers import plain_tree

    cell = spec.load_cell(workload)
    cfg = spec.model_config(cell.config)
    if overrides is not None:
        cell, cfg = overrides(cell, cfg)
    dev = torch.device(device)
    params = weights_mod.draw(plain_tree(Model(cfg, device="meta")
                                         .param_shapes()), seed, dev)
    runner_cls = harness._runner(cell.traffic["kind"])
    drv = runner_cls(cell, cfg, params, seed, dev, seconds)
    sync(dev)
    kind = cell.traffic["kind"]
    metric = "train_tokens_per_s" if kind == "train" else \
        "prefill_tokens_per_s"
    out = {"workload": workload, "seed": seed, "card": _card(),
           "torch": torch.__version__, "span_cost": _span_cost_ns(),
           "cost": _cost(drv, metric, rounds,
                         "step" if kind == "train" else "request")}

    # the traced window, as the runner sends it, keeping the profiler
    profiled = {}

    class Keep(DeviceTrace):
        def __exit__(self, *exc):
            super().__exit__(*exc)
            profiled["prof"] = self._prof
            return False

    module = sys.modules[runner_cls.__module__]
    module.DeviceTrace = Keep
    trace.reset()
    pauses = []

    def on_gc(phase, info):
        if phase == "start":
            pauses.append([time.time_ns(), None, info["generation"]])
        elif pauses:
            pauses[-1][1] = time.time_ns()

    gc.callbacks.append(on_gc)
    try:
        tr = drv.traced()
        sync(dev)
    finally:
        gc.callbacks.remove(on_gc)
    prof = profiled["prof"]
    drv.free()               # the stage actors' last spans close
    gaps = trace.profiled_gaps(prof)
    ctx = {"cell": cell, "run": cell.config["run"], "values": {},
           "trace": tr, "runner": drv}
    out.update({
        "window_s": tr["window_s"], "busy_s": tr["summary"]["busy_s"],
        "bench_gap_s": sum(g for _, g in tr["summary"]["gaps"]),
        "bench_longest_gaps": sorted(tr["summary"]["gaps"],
                                     key=lambda g: -g[1])[:5],
        "program_gap_s": sum(g for _, _, g in gaps),
        "idle_by_span": trace.idle_by_span(prof),
        "gaps_by_label": _by_label(gaps),
        "longest_gaps": _longest(gaps, trace.spans(), pauses),
        "requests": _requests(trace.spans()),
        "metrics": {m["name"]: spec.metric_reader(m["name"])(ctx)
                    for m in cell.per_layer},
        "hops_s": hops_s(),
        "summary": trace.summary(),
        "counters": trace.counters(),
        "dropped": trace.dropped()})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=os.path.join(ROOT, "work",
                                                  "idle_by_span"))
    args = ap.parse_args(argv)
    from bench_h100.run import _environment
    _environment()
    from bench_h100 import harness, spec
    try:
        harness.check_chips(spec.load_cell(args.workload).chips)
    except harness.NoChip as exc:
        print(f"no card: {exc}", file=sys.stderr)
        return 2
    out = run(args.workload, args.seed, args.seconds, args.rounds)
    for k in ("card", "span_cost", "cost", "window_s", "busy_s",
              "bench_gap_s", "bench_longest_gaps", "program_gap_s",
              "idle_by_span",
              "gaps_by_label", "longest_gaps", "metrics", "hops_s",
              "requests"):
        print(f"{k}: {out[k]}", flush=True)
    for name, row in sorted(out["summary"].items(),
                            key=lambda kv: -kv[1]["total_s"]):
        print(f"span {name}: {row}")
    print(f"counters: {out['counters']}")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{args.workload}.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
