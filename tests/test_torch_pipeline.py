"""The port's pipeline parallelism from stage actors
(``repro_torch.dist.pipeline``).

``tests/test_pipeline.py`` case for case (the staged forward equals the
fused one, stages overlap, the depth bound holds, a stage failure
propagates), ``tests/test_serve.py::test_pipeline_runner_submit_serves_
concurrent_microbatches`` and ``tests/test_graph.py::test_pipeline_
runner_over_graph`` and ``::test_pipeline_runner_rejects_both_or_neither``;
then the port's staged llama3-8b smoke forward against the JAX
``PipelineRunner`` on the same weights (``convert.params_from_jax``),
within the JAX test's 2e-4; qwen2-vl's M-RoPE positions through stages;
encdec refused. Every system is created with ``device="cpu"``.
"""
import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ActorSystem as JActorSystem
from repro.dist.pipeline import PipelineRunner as JPipelineRunner
from repro.dist.pipeline import make_layer_stage_actors as jmake_stages
from repro.models import Model as JModel
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core import (ActorSystem, DeviceRef, Graph, In, NDRange, Out,
                              dim_vec, kernel)
from repro_torch.core.memref import registry
from repro_torch.dist.pipeline import PipelineRunner, make_layer_stage_actors
from repro_torch.models import Model

N = 16


@pytest.fixture(scope="module")
def system():
    s = ActorSystem(max_workers=6, device="cpu")
    yield s
    s.shutdown()


def _tokens(cfg, n, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
            for _ in range(n)]


# ----------------------------------------------------------------------------
# tests/test_pipeline.py, case for case
# ----------------------------------------------------------------------------
def test_stage_actors_match_fused_forward(system):
    cfg = get_smoke_config("llama3-8b")  # 2 layers → 2 stages
    model = Model(cfg, device="cpu")
    params = model.init(0)
    stages = make_layer_stage_actors(system, model, params, n_stages=2)
    runner = PipelineRunner(system, stages)
    mbs = _tokens(cfg, 4)
    outs = runner.run(mbs)
    for mb, got in zip(mbs, outs):
        want, _ = model.forward(params, {"tokens": mb})
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_pipeline_overlaps_stages(system):
    """With M microbatches in flight, different stages must be active
    concurrently — the paper's async event-chain claim."""
    active = []
    lock = threading.Lock()
    overlap_seen = threading.Event()

    def make_stage(i):
        def fn(x):
            with lock:
                active.append(i)
                if len(set(active)) > 1:
                    overlap_seen.set()
            time.sleep(0.03)
            with lock:
                active.remove(i)
            return x + 1
        return fn

    s0 = system.spawn(make_stage(0))
    s1 = system.spawn(make_stage(1))
    runner = PipelineRunner(system, [s0, s1], depth=4)
    outs = runner.run(list(range(8)))
    assert outs == [x + 2 for x in range(8)]
    assert overlap_seen.is_set(), "stages never ran concurrently"


def test_pipeline_depth_bound(system):
    """No more than ``depth`` microbatches may be in flight at once."""
    peak = [0]
    inflight = [0]
    lock = threading.Lock()

    def slow_first(x):
        with lock:
            inflight[0] += 1
            peak[0] = max(peak[0], inflight[0])
        time.sleep(0.02)
        with lock:
            inflight[0] -= 1
        return x

    s0 = system.spawn(slow_first)
    s1 = system.spawn(lambda x: x)
    runner = PipelineRunner(system, [s0, s1], depth=2)
    runner.run(list(range(10)))
    assert peak[0] <= 2, peak[0]


def test_pipeline_propagates_stage_failure(system):
    s0 = system.spawn(lambda x: x)
    bad = system.spawn(lambda x: 1 / 0)
    runner = PipelineRunner(system, [s0, bad])
    with pytest.raises(Exception):
        runner.run([1, 2, 3])


# ----------------------------------------------------------------------------
# tests/test_serve.py and tests/test_graph.py's runner cases
# ----------------------------------------------------------------------------
def test_pipeline_runner_submit_serves_concurrent_microbatches(system):
    s0 = system.spawn(lambda x: x + 1)
    s1 = system.spawn(lambda x: x * 10)
    runner = PipelineRunner(system, [s0, s1], depth=3)
    futs = [runner.submit(i) for i in range(6)]
    assert [f.result(30) for f in futs] == [(i + 1) * 10 for i in range(6)]
    # run() is the same machinery
    assert runner.run(list(range(4))) == [(i + 1) * 10 for i in range(4)]


@kernel(In(torch.float32), Out(torch.float32), nd_range=NDRange(dim_vec(N)),
        name="prep")
def prep(x):
    return x + 1.0


@kernel(In(torch.float32), Out(torch.float32), nd_range=NDRange(dim_vec(N)),
        name="double")
def double(x):
    return x * 2.0


@kernel(In(torch.float32), Out(torch.float32), nd_range=NDRange(dim_vec(N)),
        name="sub3")
def sub3(x):
    return x - 3.0


@kernel(In(torch.float32), In(torch.float32), Out(torch.float32),
        nd_range=NDRange(dim_vec(N)), name="add2")
def add2(a, b):
    return a + b


def _diamond_expected(x):
    return x * 2 + x - 3


def test_pipeline_runner_over_graph(system):
    g = Graph(system, name="runner")
    s = g.source("x", torch.float32, shape=(N,))
    l, r = g.broadcast(g.apply(prep, s), 2)
    j1, j2 = g.zip_join(g.apply(double, l), g.apply(sub3, r))
    g.output(g.apply(add2, j1, j2))
    runner = PipelineRunner(system, graph=g, depth=3)
    mbs = [np.full(N, i, np.float32) for i in range(6)]
    outs = runner.run(mbs)
    for mb, out in zip(mbs, outs):
        np.testing.assert_allclose(out, _diamond_expected(mb + 1), rtol=1e-6)


def test_pipeline_runner_rejects_both_or_neither(system):
    with pytest.raises(ValueError):
        PipelineRunner(system)
    g = Graph(system, name="both")
    with pytest.raises(ValueError):
        PipelineRunner(system, [system.spawn(lambda x: x)], graph=g)


# ----------------------------------------------------------------------------
# the port against the JAX package, and what stages hand on
# ----------------------------------------------------------------------------
def test_staged_forward_matches_the_jax_pipeline_runner(system):
    cfg = get_smoke_config("llama3-8b")
    jmodel = JModel(cfg)
    jparams = jmodel.init(jax.random.key(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    mbs = _tokens(cfg, 4, seed=1)
    jsystem = JActorSystem(max_workers=4)
    try:
        jrunner = JPipelineRunner(
            jsystem, jmake_stages(jsystem, jmodel, jparams, n_stages=2))
        want = jrunner.run([jnp.asarray(mb) for mb in mbs])
    finally:
        jsystem.shutdown()
    model = Model(cfg, device="cpu")
    runner = PipelineRunner(
        system, make_layer_stage_actors(system, model, params, n_stages=2))
    got = runner.run(mbs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("n_stages", [1, 2, 3, 4])
def test_stages_split_the_layers_and_hand_on_device_refs(system, n_stages):
    """Any split of 4 layers of qwen3-1.7b's smoke widths gives the fused
    logits bit for bit (the same ops in the same order); the activation
    crosses as a DeviceRef, with no host transfer or spill."""
    cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"), n_layers=4)
    model = Model(cfg, device="cpu")
    params = model.init(3)
    stages = make_layer_stage_actors(system, model, params, n_stages)
    assert len(stages) == n_stages
    before = registry.stats()
    mbs = [torch.from_numpy(t) for t in _tokens(cfg, 3, seed=2)]
    refs = PipelineRunner(system, stages).run(mbs, emit="ref")
    after = registry.stats()
    assert (after["transfers"], after["spills"]) == \
        (before["transfers"], before["spills"])
    for mb, ref in zip(mbs, refs):
        assert isinstance(ref, DeviceRef) and ref.device.type == "cpu"
        want, _ = model.forward(params, {"tokens": mb})
        assert torch.equal(ref.array, want)
    with pytest.raises(ValueError):
        make_layer_stage_actors(system, model, params, cfg.n_layers + 1)


def test_stages_take_m_rope_positions(system):
    """qwen2-vl's [3,B,S] M-RoPE positions through stages: the staged
    logits equal the fused forward's at the default positions."""
    cfg = get_smoke_config("qwen2-vl-2b")
    model = Model(cfg, device="cpu")
    params = model.init(4)
    runner = PipelineRunner(
        system, make_layer_stage_actors(system, model, params, n_stages=2))
    mbs = _tokens(cfg, 2, seed=5)
    for mb, got in zip(mbs, runner.run(mbs)):
        want, _ = model.forward(params, {"tokens": mb})
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_encdec_is_refused(system):
    cfg = get_smoke_config("whisper-tiny")
    model = Model(cfg, device="cpu")
    with pytest.raises(NotImplementedError):
        make_layer_stage_actors(system, model, model.param_shapes(), 2)


def test_spill_emits_spilled_refs(system):
    s0 = system.spawn(lambda x: x + 1)
    runner = PipelineRunner(system, [s0])
    (ref,) = runner.run([torch.arange(4.0)], emit="spill")
    assert isinstance(ref, DeviceRef) and ref.is_spilled
    with pytest.raises(ValueError):
        runner.submit(1, emit="bogus")
