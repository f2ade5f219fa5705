"""The per-layer metrics that read the program's own spans and counters
(``source`` ``program_span`` or ``program_counter``): a CPU traced run of
each cell reports every one of them that the cell lists, as a number.
``flash_host.prefill`` reads the span around the flash-attention kernel's
host side, which only the card runs: on the CPU it is left out. The
actor hop that ``mailbox_wait.prefill`` reads leaves out the wait behind
the actor's earlier bodies."""
import json
import math
import os
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PROGRAM = ("program_span", "program_counter")
#: metrics whose spans only a run on the card records
CARD_ONLY = {"flash_host.prefill"}


def _cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    return [w["name"] for w in bench["workloads"]
            if any(m["source"] in PROGRAM and w["name"] in m["workloads"]
                   for m in bench["per_layer"])]


@pytest.mark.parametrize("workload", _cells())
def test_traced_run_reports_the_program_metrics(workload, small):
    from bench_h100.harness import run_cell
    from bench_h100.spec import load_cell
    from repro_torch import trace
    cell = load_cell(workload)
    names = {m["name"] for m in cell.per_layer if m["source"] in PROGRAM}
    assert names
    trace.reset()
    r = run_cell(workload, 2 ** 33 + 11, 0.6, True,
                 t_start=time.perf_counter(), device="cpu", overrides=small,
                 log=lambda m: None)
    assert r["correct"] is True, r["checks"]
    for name in sorted(names - CARD_ONLY):
        v = r["metrics"][name]["value"]
        assert isinstance(v, float) and math.isfinite(v) and v > 0, name
    assert not names & CARD_ONLY & set(r["metrics"])
    if "moe_fill.prefill" in names:
        assert r["metrics"]["moe_fill.prefill"]["value"] <= 100.0
    if "stage_host.prefill" in names:
        assert r["metrics"]["stage_host.prefill"]["value"] <= 100.0


def test_the_hop_leaves_out_the_wait_behind_earlier_bodies():
    from bench_h100.metrics._program import hops_s
    from repro_torch import trace
    from repro_torch.core import ActorSystem

    body_s = 0.05
    system = ActorSystem(max_workers=2, device="cpu")
    try:
        slow = system.spawn(lambda x: time.sleep(body_s) or x)
        with trace.recording():
            futs = [slow.request(i) for i in range(3)]
            assert [f.result(timeout=10) for f in futs] == [0, 1, 2]
            waits = [(s.end - s.start) / 1e9 for s in trace.spans()
                     if s.name == "actor.mailbox"]
            hops = hops_s()
    finally:
        system.shutdown()
    # the third message waited out two bodies, its hop none of them
    assert len(waits) == len(hops) == 3
    assert max(waits) > 1.5 * body_s
    assert all(0 <= h < body_s / 2 for h in hops)
