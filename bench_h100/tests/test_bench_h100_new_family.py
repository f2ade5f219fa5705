"""A configuration of a family the harness was not written for joins the
benchmark by new files and entries only. ``new_family/`` holds two: the
port's mamba2-130m (ssm) and recurrentgemma-9b (hybrid), each with a
``draw`` table and ``smoke`` sizes in its configuration file, a
``reference/<config>.py`` (the port's plain path standing in, which is
enough to test the plumbing) and a ``counts/<config>.py`` in which only
the attention layers count toward B6's bound. They are added to a copy of
the benchmark with one prefill cell each, and run end to end through
``run_cell`` on the CPU, untraced and traced, in a process that imports
the copy. No file of the copy's harness differs from ``bench_h100/``."""
import filecmp
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
FIXTURE = os.path.join(HERE, "new_family")
#: attention layers of each configuration at its smoke sizes
ATTENTION_LAYERS = {"mamba2-130m": 0, "recurrentgemma-9b": 1}
TRAFFIC = "prefill-mixed-4k"
SKIP = ("__pycache__", "cache")

DRIVE = r'''
import importlib.util, json, sys, time
copy, src = sys.argv[1:3]
sys.path[:0] = [src, copy]
import bench_h100
assert bench_h100.__file__.startswith(copy), bench_h100.__file__
from bench_h100 import flops, spec
from bench_h100.harness import run_cell
s = importlib.util.spec_from_file_location(
    "small", f"{copy}/bench_h100/tests/conftest.py")
m = importlib.util.module_from_spec(s)
s.loader.exec_module(m)
out = {}
for c in sys.argv[3:]:
    w = f"{c}.prefill-mixed"
    for trace in (False, True):
        r = run_cell(w, 2 ** 33 + 19, 0.5, trace, t_start=time.perf_counter(),
                     device="cpu", overrides=m.small_cell, log=lambda _: None)
        out[f"{w} {int(trace)}"] = {k: r[k] for k in (
            "correct", "attempted", "failed", "metrics", "checks")}
    run = m.small_cell(spec.load_cell(w), None)[0].config["run"]
    out[c] = {"bound": spec.counts(c).flash_bound_s(run, 2, 16),
              "launch": flops.flash_bound_s(run, 2, 16) if run["n_heads"]
              else None, "n_layers": run["n_layers"]}
print(json.dumps(out))
'''


def _files(root):
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x not in SKIP]
        for f in files:
            yield os.path.relpath(os.path.join(d, f), root)


def _add(copy):
    """Copy the fixture's files to their places in ``copy``'s harness, each
    a file it did not have, and add the entries to its BENCHMARK.json. →
    the files added."""
    added = set()
    for rel in _files(FIXTURE):
        sub = rel.split(os.sep)[0]
        targets = ([os.path.join(sub, f"{c}.py") for c in ATTENTION_LAYERS]
                   if sub == "reference" else [rel])
        for t in targets:
            dst = os.path.join(copy, "bench_h100", t)
            assert not os.path.exists(dst), t
            shutil.copyfile(os.path.join(FIXTURE, rel), dst)
            added.add(t)
    path = os.path.join(copy, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    for c in ATTENTION_LAYERS:
        w = f"{c}.prefill-mixed"
        with open(os.path.join(FIXTURE, "configs", f"{c}.json")) as f:
            source = json.load(f)["source"]
        bench["configs"].append({"name": c, "source": source,
                                 "file": f"bench_h100/configs/{c}.json",
                                 "reduced": [], "why": "a test fixture"})
        bench["workloads"].append({"name": w, "config": c,
                                   "traffic": TRAFFIC, "chips": 1,
                                   "why": "a test fixture"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if m["name"] in ("prefill_tokens_per_s", "mfu.prefill",
                             "flash_roofline.prefill", "device_idle.prefill"):
                m["workloads"].append(w)
    with open(path, "w") as f:
        json.dump(bench, f)
    return added


def test_new_families_join_by_new_files_and_entries_only(tmp_path):
    copy = str(tmp_path)
    shutil.copytree(BENCH, os.path.join(copy, "bench_h100"),
                    ignore=shutil.ignore_patterns(*SKIP))
    shutil.copyfile(os.path.join(ROOT, "BENCHMARK.json"),
                    os.path.join(copy, "BENCHMARK.json"))
    added = _add(copy)
    out = subprocess.run(
        [sys.executable, "-c", DRIVE, copy, os.path.join(ROOT, "src"),
         *ATTENTION_LAYERS], capture_output=True, text=True, cwd=copy,
        timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for c, n_attn in ATTENTION_LAYERS.items():
        for trace in (0, 1):
            r = res[f"{c}.prefill-mixed {trace}"]
            assert r["correct"] is True, (c, trace, r["checks"])
            assert r["attempted"] > 0 and r["failed"] == 0
            # the traced run's MFU reads the configuration's own count:
            # flops.py's would divide by mamba2's 0 heads
            name = "mfu.prefill" if trace else "prefill_tokens_per_s"
            assert r["metrics"][name]["value"] > 0, (c, trace)
        b = res[c]
        assert n_attn < b["n_layers"]
        if n_attn:
            assert b["bound"] == n_attn * b["launch"]
        else:
            assert b["bound"] == 0.0
    theirs = set(_files(os.path.join(copy, "bench_h100")))
    ours = set(_files(BENCH))
    assert theirs - ours == added
    for rel in ours:
        assert filecmp.cmp(os.path.join(BENCH, rel),
                           os.path.join(copy, "bench_h100", rel),
                           shallow=False), rel
