"""Every cell of BENCHMARK.json is found by name and runs end to end on the
CPU at small sizes; the result line has the keys a reader of it takes."""
import json
import os
import subprocess
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.parametrize("workload", _cells())
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_end_to_end(workload, trace, small):
    from bench_h100.harness import run_cell
    from bench_h100.spec import load_cell
    cell = load_cell(workload)
    r = run_cell(workload, 2 ** 33 + 7, 0.6, trace, t_start=time.perf_counter(),
                 device="cpu", overrides=small, log=lambda m: None)
    assert r["correct"] is True, r["checks"]
    keys = list(r)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert ("breakdown" in r) == trace
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    if trace:
        assert set(r["device"]) >= {"busy_s", "window_s"}
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        allowed = {m["name"] for m in cell.per_layer}
    else:
        allowed = {m["name"] for m in cell.end_to_end}
        assert set(r["metrics"]) == allowed
        assert r["metrics"]["setup_s"]["value"] > 0
    assert set(r["metrics"]) <= allowed
    for name, c in r["checks"].items():
        assert c["value"] <= c["limit"], name
    json.dumps(r)


def test_every_cell_reports_setup_another_e2e_and_a_per_layer_metric():
    from bench_h100.spec import load_cell, metric_reader
    for w in _cells():
        cell = load_cell(w)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2, w
        assert cell.per_layer, w
        for m in cell.per_layer:
            assert m["moves"] in names, (w, m["name"])
            assert callable(metric_reader(m["name"]))


def test_unknown_workload_is_refused():
    from bench_h100.spec import load_cell
    with pytest.raises(KeyError):
        load_cell("no-such-cell")


def test_command_without_a_card_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench_h100", "run.py"),
         "--workload", _cells()[0], "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no result" in out.stderr


def test_traffic_gives_every_seed_the_same_work():
    import itertools
    from bench_h100 import traffic
    from bench_h100.spec import load_cell
    mix = load_cell("qwen3-1.7b.prefill-mixed").traffic
    a = list(itertools.islice(traffic.backlog(mix, 1), 400))
    b = list(itertools.islice(traffic.backlog(mix, 2 ** 31 + 5), 400))
    assert [r.index for r in a] == list(range(400))
    for i in range(0, 400, 4):              # every cycle has every shape
        assert sorted((r.batch, r.seq) for r in a[i:i + 4]) == \
            sorted((r.batch, r.seq) for r in b[i:i + 4]) == \
            sorted(tuple(s) for s in mix["shapes"])
    assert [(r.batch, r.seq) for r in a] != [(r.batch, r.seq) for r in b]
    assert all(r.tokens == 8192 for r in a)
