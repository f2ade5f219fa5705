"""The port's tracer (``repro_torch.trace``) on the CPU.

The off path records nothing and hands out one shared no-op; spans nest
by parent id under ``recording()`` and under ``torch.profiler``; one
request id follows ``PipelineRunner.submit`` through a graph's mailbox
hops to the ``stage``, ``layer`` and ``moe.*`` spans on the actor
threads, and a train step's recompute ``layer`` spans carry the step's id
under ``train.backward``; no span reaches the profiler's events, and a
``record_function`` opened inside a span starts inside it on the
profiler's clock; the MoE counters equal a hand count; ``label_gaps``
labels the gaps of a synthetic trace; the record is bounded; self time,
and the counters read from their owners as their growth in the record.
"""
import dataclasses
import gc
import math
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import trace
from repro_torch.configs import get_smoke_config
from repro_torch.core import ActorSystem
from repro_torch.core.api import Pipeline
from repro_torch.dist.pipeline import PipelineRunner, make_layer_stage_actors
from repro_torch.dist.step import build_train_step, init_train_state
from repro_torch.models import Model, moe
from repro_torch.optim import AdamWConfig

MOE = "phi3.5-moe-42b-a6.6b"
#: every span name the port records
PROGRAM_SPANS = {"pipeline.submit", "pipeline.admit", "actor.mailbox",
                 "actor.receive", "stage", "stage.head", "layer", "moe.route",
                 "moe.dispatch", "moe.experts", "moe.combine",
                 "stage.embed", "kernel.flash_attention", "train.step", "train.forward",
                 "train.backward", "optim.adamw", "optim.norm",
                 "optim.leaves"}


@pytest.fixture
def system():
    s = ActorSystem(max_workers=4, device="cpu")
    yield s
    s.shutdown()


def _names(spans):
    return [s.name for s in spans]


def test_off_path_records_nothing_and_returns_the_shared_noop():
    assert not trace.enabled()
    trace.reset()
    a, b = trace.span("a", x=1), trace.request("b")
    assert a is b is trace.span("c")
    with a:
        with trace.span("d"):
            trace.count("n", 3)
    assert trace.stamp() is None and trace.current() is None
    assert trace.span_from((0, 1, 2), "e") is a
    trace.waited((0, 1, 2), "f")
    assert trace.spans() == [] and "n" not in trace.counters()


@pytest.mark.parametrize("how", ["recording", "profiler"])
def test_spans_nest_by_parent_id(how):
    trace.reset()
    ctx = (trace.recording() if how == "recording"
           else profile(activities=[ProfilerActivity.CPU]))
    with ctx:
        assert trace.enabled()
        with trace.request("top", k=1) as top:
            with trace.span("mid") as mid:
                with trace.span("leaf") as leaf:
                    pass
            with trace.span("mid2") as mid2:
                pass
    assert not trace.enabled()
    got = {s.name: s for s in trace.spans()}
    assert set(got) == {"top", "mid", "leaf", "mid2"}
    assert got["top"].parent is None and got["top"].attrs == {"k": 1}
    assert (mid.parent, leaf.parent, mid2.parent) == (top.id, mid.id, top.id)
    assert {s.rid for s in got.values()} == {top.id}
    assert {s.thread for s in got.values()} == {threading.get_native_id()}
    assert top.start <= mid.start <= leaf.start <= leaf.end <= mid.end \
        <= mid2.start <= mid2.end <= top.end


def test_one_request_id_follows_submit_through_the_actor_hops(system):
    cfg = get_smoke_config(MOE)
    model = Model(cfg, device="cpu")
    params = model.init(0)
    # two stages: the runner's chain is a graph, so the request also
    # crosses the graph orchestrator's mailbox
    runner = PipelineRunner(system, make_layer_stage_actors(
        system, model, params, n_stages=2))
    tok = torch.randint(0, cfg.vocab_size, (2, 16))
    runner.submit(tok).result(timeout=60)          # built, warm
    with trace.recording():
        runner.submit(tok).result(timeout=60)
    system.shutdown()       # the last receive span closes after its reply
    spans = trace.spans()
    submit = next(s for s in spans if s.name == "pipeline.submit")
    assert submit.rid == submit.id and submit.parent is None
    assert {s.rid for s in spans} == {submit.id}
    names = _names(spans)
    assert names.count("stage") == names.count("stage.embed") == 2
    assert names.count("stage.head") == 1
    assert names.count("layer") == cfg.n_layers
    assert names.count("actor.receive") == 3        # the graph, two stages
    assert names.count("actor.mailbox") == 3
    for n in ("moe.route", "moe.dispatch", "moe.experts", "moe.combine"):
        assert names.count(n) == cfg.n_layers
    main = threading.get_native_id()
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name in ("stage", "layer") or s.name.startswith("moe."):
            assert s.thread != main
        if s.name == "stage":
            assert by_id[s.parent].name == "actor.receive"
        if s.name in ("stage.embed", "stage.head"):
            assert by_id[s.parent].name == "stage"
        if s.name == "layer":
            assert by_id[s.parent].name == "stage"
        if s.name.startswith("moe."):
            assert by_id[s.parent].name == "layer"
    admit = next(s for s in spans if s.name == "pipeline.admit")
    assert admit.parent == submit.id
    for s in spans:
        if s.name == "actor.mailbox":
            assert s.wait and s.parent in by_id
            body = next(r for r in spans if r.name == "actor.receive"
                        and r.parent == s.parent and r.thread == s.thread)
            assert s.end <= body.start
            assert s.attrs["actor"] == body.attrs["actor"]


def test_an_inline_call_records_its_receive_on_the_callers_thread(system):
    g = Pipeline(system, mode="staged").stages(
        [lambda x: x + 1, lambda x: x * 2]).build()
    with trace.recording():
        with trace.request("ask") as ask:
            assert g.ask(3) == 8
    inline = [s for s in trace.spans() if s.name == "actor.receive"
              and s.attrs["inline"] == 1]
    assert inline and g.dispatch_stats["inline"] >= len(inline)
    for s in inline:
        assert s.rid == ask.id and s.thread == threading.get_native_id()


def test_recompute_layers_carry_the_steps_id_under_backward():
    cfg = get_smoke_config("qwen3-1.7b")
    assert cfg.remat == "full"
    model = Model(cfg, device="cpu")
    ocfg = AdamWConfig()
    state = init_train_state(model, 0, ocfg)
    step = build_train_step(model, ocfg)
    seq = torch.randint(0, cfg.vocab_size, (2, 17))
    with trace.recording():
        step(state, {"tokens": seq[:, :-1], "labels": seq[:, 1:]})
    spans = trace.spans()
    by = {n: [s for s in spans if s.name == n] for n in set(_names(spans))}
    (st,), (fw,), (bw,), (opt,) = (by["train.step"], by["train.forward"],
                                   by["train.backward"], by["optim.adamw"])
    assert {s.rid for s in spans} == {st.id}
    assert fw.parent == bw.parent == opt.parent == st.id
    assert [s.parent for s in by["optim.norm"] + by["optim.leaves"]] == \
        [opt.id, opt.id]
    fwd = [s for s in by["layer"] if s.attrs["recompute"] == 0]
    rec = [s for s in by["layer"] if s.attrs["recompute"] == 1]
    assert sorted(s.attrs["index"] for s in fwd) == list(range(cfg.n_layers))
    assert sorted(s.attrs["index"] for s in rec) == list(range(cfg.n_layers))
    assert {s.parent for s in fwd} == {fw.id}
    assert {s.parent for s in rec} == {bw.id}
    assert all(bw.start <= s.start <= s.end <= bw.end for s in rec)


def test_a_recompute_on_another_thread_takes_the_forward_threads_span():
    handle = trace.here()
    with trace.recording():
        with trace.request("step") as step, trace.span("backward") as bw:
            out = []
            th = threading.Thread(target=lambda: out.append(
                trace.span_within(handle, "layer").__enter__()))
            th.start()
            th.join(timeout=10)
            assert not th.is_alive()
    (sp,) = out
    assert (sp.parent, sp.rid) == (bw.id, step.id)
    assert sp.thread == th.native_id


def test_no_program_span_reaches_the_profilers_events(system):
    cfg = get_smoke_config(MOE)
    model = Model(cfg, device="cpu")
    runner = PipelineRunner(system, make_layer_stage_actors(
        system, model, model.init(0), n_stages=1))
    tok = torch.randint(0, cfg.vocab_size, (1, 16))
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        runner.submit(tok).result(timeout=60)
        state = init_train_state(model, 0, AdamWConfig())
        seq = torch.randint(0, cfg.vocab_size, (1, 17))
        build_train_step(model, AdamWConfig())(
            state, {"tokens": seq[:, :-1], "labels": seq[:, 1:]})
    system.shutdown()
    recorded = set(_names(trace.spans()))
    assert recorded >= PROGRAM_SPANS - {"kernel.flash_attention"}
    events = {e.name for e in prof.events()}
    events |= {e.name() for e in prof.profiler.kineto_results.events()}
    assert not events & recorded


def test_a_record_function_inside_a_span_starts_inside_it():
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with trace.span("outer"):
                with record_function("rf"):
                    torch.ones(8).sum()
    outer = [s for s in trace.spans() if s.name == "outer"]
    rf = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                if e.name() == "rf")
    assert len(outer) == len(rf) == 3
    tol = 50_000                                     # 50 us
    for s, t in zip(outer, rf):
        assert s.start - tol <= t <= s.end + tol, (s.start, t, s.end)


def test_moe_counters_equal_a_hand_count_with_capacity_drops():
    cfg = get_smoke_config(MOE)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, group_size=8, capacity_factor=0.5))
    p = Model(cfg, device="cpu").init(1)["layers"][0]["moe"]
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(2)).to(cfg.dtype())
    with trace.recording():
        moe.apply_moe(p, cfg, x)
    got = trace.counters()
    e, k, g = cfg.moe.n_experts, cfg.moe.top_k, 8
    cap = max(math.ceil(k * g / e * cfg.moe.capacity_factor), 1)
    _, _, topi = moe.route(p, cfg, x.reshape(-1, g, cfg.d_model))
    kept = 0
    for group in topi.tolist():                     # [g, k] each
        queue = [0] * e
        for token in group:
            for expert in token:
                kept += queue[expert] < cap
                queue[expert] += 1
    groups = topi.shape[0]
    assert got["moe.slots"] == groups * e * cap
    assert got["moe.assigned"] == groups * g * k
    assert got["moe.filled"] == kept
    assert got["moe.dropped"] == groups * g * k - kept > 0


def _done(name, start, end, thread=1, wait=False, parent=None):
    sp = trace.Span(name, {})
    sp.start, sp.end, sp.thread, sp.wait = start, end, thread, wait
    sp.id, sp.parent, sp.rid = id(sp), parent, None
    return sp


def test_label_gaps_on_a_synthetic_trace():
    device = [(0, 10, 1), (20, 30, 2), (25, 40, 3), (50, 60, 4),
              (70, 80, 5), (100, 110, 6), (130, 140, 7)]
    launches = {1: (0, 1, 1), 2: (5, 15, 1), 3: (16, 17, 1),
                4: (45, 46, 1), 5: (5, 6, 1), 6: (95, 96, 2),
                7: (120, 121, 1)}
    of = [_done("stage", 0, 200),
          _done("layer", 8, 48),
          _done("kernel.flash_attention", 39, 47),
          _done("actor.mailbox", 0, 200, wait=True),
          _done("submit", 90, 150, thread=3)]
    got = trace.label_gaps(device, launches, of)
    assert [g for _, _, g in got] == [10e-9, 10e-9, 10e-9, 20e-9, 20e-9]
    assert [t for _, t, _ in got] == [10, 40, 60, 80, 110]
    assert [label for label, _, _ in got] == [
        "layer", "kernel.flash_attention", "not_host", "none", "stage"]
    # 10-20: the layer open on thread 1 at 10 (its launch call still
    # running); 40-50: the flash span in it; 60-70: launched by 6, before
    # the gap; 80-100: thread 2 had no span open; 110-130: the stage; the
    # mailbox wait labels nothing
    del launches[7]
    assert trace.label_gaps(device, launches, of)[-1] == \
        ("unlinked", 110, 20e-9)


class _Event:
    """A profiler event as ``kineto_results.events()`` gives it."""

    def __init__(self, name, cuda, start, end, corr, tid=0, note=False):
        self._v = name, cuda, start, end, corr, tid, note

    def name(self):
        return self._v[0]

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._v[1] else DeviceType.CPU

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3] - self._v[2]

    def correlation_id(self):
        return self._v[4]

    def device_resource_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


class _Prof:
    def __init__(self, events):
        results = type("R", (), {"events": lambda _self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def test_idle_by_span_links_launches_by_correlation_and_thread():
    out = {}

    def work():
        with trace.span("feed") as sp:
            out["span"] = sp
        out["pthread"] = trace._int32(threading.get_ident())

    with trace.recording():
        th = threading.Thread(target=work)
        th.start()
        th.join(timeout=10)
    sp = out["span"]
    t0 = sp.start
    assert sp.end > t0 + 1
    events = [
        _Event("kernel_a", True, t0 - 100, t0 + 1, 7),
        _Event("cudaLaunchKernel", False, t0 - 120, t0 - 110, 7, 1),
        # annotations of host ranges on the card's timeline: not work,
        # though one's id is a launch's
        _Event("bench.submit", True, t0 - 50, t0 + 400, 8, note=True),
        _Event("bench.submit", False, t0 - 60, t0 + 400, 8, 1, note=True),
        _Event("autograd::engine", True, t0 - 50, t0 + 400, 7, note=True),
        # launched by the worker, named by its 32-bit pthread id, after
        # the gap began at t0 + 1, in the worker's span
        _Event("kernel_b", True, t0 + 91, t0 + 99, 9),
        _Event("cudaLaunchKernelExC", False, t0 - 10, t0 + 5, 9,
               out["pthread"])]
    assert trace.profiled_gaps(_Prof(events)) == [("feed", t0 + 1, 90e-9)]
    assert trace.idle_by_span(_Prof(events)) == {"feed": 90e-9}


def test_idle_by_span_reads_a_profiler_run_without_a_card():
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("work"):
            torch.ones(64).sum()
    assert trace.idle_by_span(prof) == {}


def test_the_record_is_bounded_and_counts_its_drops():
    with trace.recording(max_spans=3):
        for i in range(5):
            with trace.span(f"s{i}"):
                pass
    assert _names(trace.spans()) == ["s2", "s3", "s4"]
    assert trace.dropped() == 2


def test_summary_takes_self_time_from_the_children():
    top = _done("top", 0, 10_000_000)
    kids = [_done("kid", 1_000_000, 4_000_000, parent=top.id),
            _done("kid", 3_000_000, 5_000_000, parent=top.id),
            _done("kid", 9_000_000, 12_000_000, parent=top.id)]
    s = trace.summary([top] + kids)
    assert s["top"]["count"] == 1
    assert s["top"]["total_s"] == pytest.approx(0.010)
    assert s["top"]["self_s"] == pytest.approx(0.010 - 0.004 - 0.001)
    assert s["kid"]["count"] == 3 and s["kid"]["self_s"] == \
        pytest.approx(0.008)
    assert s["kid"]["p50_s"] == pytest.approx(0.003)
    assert s["kid"]["p99_s"] == pytest.approx(0.003)


def test_device_time_counts_the_blocks_time_on_the_cpu_while_recording():
    cpu = torch.device("cpu")
    trace.reset()
    assert trace.device_time("t_ns", cpu) is trace.NOOP
    with trace.recording():
        for _ in range(2):
            with trace.span("timed"), trace.device_time("t_ns", cpu):
                torch.ones(256, 256) @ torch.ones(256, 256)
        spans = trace.spans()
        got = trace.counters()["t_ns"]
    held = sum(s.end - s.start for s in spans if s.name == "timed")
    assert 0 < got <= held


def test_counters_read_their_owners_and_device_adds(system):
    g = Pipeline(system, mode="staged").stages(
        [lambda x: x + 1, lambda x: x * 2]).build()
    g.request(1).result(timeout=10)

    class Owner:
        n = 7

    owner = Owner()
    trace.reads(owner, lambda o: {"owner.n": o.n})
    before = dict(g.dispatch_stats)
    with trace.recording():
        trace.count("dev", torch.tensor(2))
        trace.count("dev", torch.tensor(3))
        owner.n += 4
        g.request(1).result(timeout=10)
        late = Owner()                   # made inside: counts from its start
        trace.reads(late, lambda o: {"late.n": o.n})
        got = trace.counters()
    # an owner's counters are what they grew by in the record
    assert got["dev"] == 5 and got["owner.n"] == 4 and got["late.n"] == 7
    grown = {k: g.dispatch_stats[k] - before[k] for k in before}
    assert sum(grown.values()) > 0
    assert (got["graph.inline"], got["graph.mailbox"]) == \
        (grown["inline"], grown["mailbox"])
    assert {"cuda.launches", "memref.transfers", "memref.spills"} <= set(got)
    del owner, late
    gc.collect()
    assert "owner.n" not in trace.counters()

