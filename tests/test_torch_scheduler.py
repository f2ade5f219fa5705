"""The port's chunk scheduler, fractional offload, ``ActorPool.map`` and
``Graph.map_over``.

Behaviours carried over from ``tests/test_facade.py`` (split_offload
sweep, straggler re-issue, failure, elastic workers),
``tests/test_memref_plane.py`` (residency-aware pick, ref payloads),
``tests/test_serve.py`` (earliest-deadline-first, shedding),
``tests/test_api.py`` (pool + scheduler, ``pool.map``) and
``tests/test_graph.py`` (``map_over``), with one parity test against the
JAX package's ``Graph.map_over``. Every system is created with
``device="cpu"``.
"""
import gc
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro_torch.core import (ActorPool, ActorSystem, ChunkScheduler,
                              DeadlineExceeded, DeviceRef, Graph, GraphError,
                              In, NDRange, Out, dim_vec, kernel,
                              live_ref_count, reset_transfer_stats,
                              split_offload, transfer_count)
from repro_torch.core import scheduler as scheduler_module
from repro_torch.core.scheduler import WorkItem

CPU = torch.device("cpu")
N = 16


@pytest.fixture(scope="module")
def system():
    s = ActorSystem(max_workers=8, device="cpu")
    yield s
    s.shutdown()


@pytest.fixture(scope="module")
def mngr(system):
    return system.opencl_manager()


@pytest.fixture()
def ref_baseline():
    gc.collect()
    return live_ref_count()


def assert_refs_settle(baseline: int, timeout: float = 5.0) -> None:
    deadline = time.monotonic() + timeout
    while True:
        gc.collect()
        n = live_ref_count()
        if n <= baseline:
            return
        if time.monotonic() > deadline:
            assert n == baseline, f"{n - baseline} DeviceRefs leaked"
        time.sleep(0.02)


@kernel(In(torch.float32), Out(torch.float32), nd_range=NDRange(dim_vec(N)),
        name="prep")
def prep(x):
    return x + 1.0


@kernel(In(torch.float32), Out(torch.float32), nd_range=NDRange(dim_vec(N)),
        name="double")
def double(x):
    return x * 2.0


@kernel(In(torch.float32), In(torch.float32), Out(torch.float32),
        nd_range=NDRange(dim_vec(N)), name="add2")
def add2(a, b):
    return a + b


class _StubDevice:
    """Quacks like repro_torch.core.manager.Device for routing tests."""

    def __init__(self, torch_device):
        self.torch_device = torch_device

    def queue_depth(self):
        return 0

    def live_bytes(self):
        return 0


# ----------------------------------------------------------------------------
# split_offload (paper Fig. 7)
# ----------------------------------------------------------------------------
def test_split_offload_sweep(mngr):
    w1 = mngr.spawn(kernel(In(torch.float32), Out(torch.float32),
                           name="w1")(lambda x: x * x))
    w2 = mngr.spawn(kernel(In(torch.float32), Out(torch.float32),
                           name="w2")(lambda x: x * x))
    data = np.arange(64, dtype=np.float32)
    for frac in [0.0, 0.3, 0.5, 1.0]:
        def sizes_of(fr):
            a = int(64 * fr[0])
            return [a, 64 - a]

        out = split_offload([w1, w2], [frac, 1.0 - frac],
                            make_payload=lambda s, n: (data[s:s + n],),
                            sizes_of=sizes_of,
                            combine=lambda rs: np.concatenate(rs))
        np.testing.assert_allclose(out, data * data)


def test_split_offload_needs_one_fraction_per_worker(system):
    w = system.spawn(lambda s, n: s)
    with pytest.raises(ValueError, match="one fraction per worker"):
        split_offload([w], [0.5, 0.5], make_payload=lambda s, n: (s, n),
                      sizes_of=lambda fr: [1, 1], combine=list)


# ----------------------------------------------------------------------------
# ChunkScheduler: failure, stragglers, elastic workers
# ----------------------------------------------------------------------------
def test_chunk_scheduler_straggler_and_failure(mngr):
    calls = {"n": 0}

    def flaky(x):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient")
        return x + 1.0

    # flaky dies after its first failure (actor semantics): the scheduler
    # must finish every chunk on the surviving worker
    wf = mngr.spawn(kernel(In(torch.float32), Out(torch.float32),
                           name="flaky")(flaky))
    ws = mngr.spawn(kernel(In(torch.float32), Out(torch.float32),
                           name="steady")(lambda x: x + 1.0))
    sched = ChunkScheduler([wf, ws])
    res = sched.run([(np.full(4, i, np.float32),) for i in range(6)],
                    timeout=60)
    for i, r in enumerate(res):
        np.testing.assert_allclose(r, i + 1)
    assert sched.stats["failed"] >= 1


def test_chunk_scheduler_speculative_reissue_beats_straggler(system):
    """A slow straggler loses to the speculatively re-issued copy, and
    each chunk's result appears exactly once."""
    def slow(x):
        time.sleep(1.0)
        return ("slow", x + 1)

    def fast(x):
        time.sleep(0.001)
        return ("fast", x + 1)

    ws, wf = system.spawn(slow), system.spawn(fast)
    sched = ChunkScheduler([ws, wf], straggler_factor=3.0, drain_grace=3.0)
    res = sched.run([(i,) for i in range(8)], timeout=60)
    assert [v for _, v in res] == [i + 1 for i in range(8)]
    assert all(tag == "fast" for tag, _ in res), res
    assert sched.stats["speculative"] >= 1
    assert sched.stats["dispatched"] >= 9


def test_chunk_scheduler_elastic_add_remove(mngr):
    ident = kernel(In(torch.float32), Out(torch.float32), name="e")(lambda x: x)
    w1 = mngr.spawn(ident)
    sched = ChunkScheduler([w1])
    w2 = mngr.spawn(ident)
    sched.add_worker(w2)
    assert len(sched.workers) == 2
    assert len(sched.run([(np.full(2, i, np.float32),) for i in range(4)])) == 4
    sched.remove_worker(w1)
    assert len(sched.workers) == 1


def test_chunk_scheduler_fails_fast_without_live_workers(system):
    def bad(x):
        raise ValueError("poison")

    w = system.spawn(bad)
    with pytest.raises((ValueError, RuntimeError)):
        ChunkScheduler([w], max_attempts=1).run([(1,), (2,)], timeout=30)
    with pytest.raises(RuntimeError, match="no live workers"):
        ChunkScheduler([w]).run([(1,)])


# ----------------------------------------------------------------------------
# placement-aware pick and DeviceRef payloads
# ----------------------------------------------------------------------------
def test_chunk_scheduler_take_pending_prefers_resident_chunks(system):
    """A worker grabs the chunk already resident on its device, a foreign
    worker prefers affinity-free chunks, and FIFO is the fallback."""
    w_other = system.spawn(lambda *a: None)
    w_local = system.spawn(lambda *a: None)
    ref = DeviceRef.put(np.ones(2, np.float32), device=CPU)
    sched = ChunkScheduler(
        [w_other, w_local],
        devices=[_StubDevice("elsewhere"), _StubDevice(ref.device)])
    items = [WorkItem(0, (0, None)), WorkItem(1, (1, ref)),
             WorkItem(2, (2, ref))]
    pending = list(items)
    assert sched._take_pending(pending, w_local) is items[1]
    assert sched._take_pending(pending, w_other) is items[0]
    assert sched._take_pending(pending, w_other) is items[2]
    ref.release()


def test_chunk_scheduler_ref_payloads_end_to_end(system):
    ref = DeviceRef.put(np.float32(10.0), device=CPU)
    workers = [system.spawn(
        lambda i, r: i + (float(r.to_value()) if r is not None else 0.0))
        for _ in range(2)]
    res = ChunkScheduler(workers).run(
        [(i, ref if i % 2 else None) for i in range(6)], timeout=60)
    assert [int(x) for x in res] == [0, 11, 2, 13, 4, 15]
    ref.release()


# ----------------------------------------------------------------------------
# deadlines
# ----------------------------------------------------------------------------
def test_chunk_scheduler_earliest_deadline_first(system):
    order = []

    def record(tag):
        order.append(tag)
        return tag

    w = system.spawn(record)
    now = time.monotonic()
    out = ChunkScheduler([w]).run([("late",), ("soon",), ("mid",)],
                                  deadlines=[now + 30, now + 10, now + 20])
    assert out == ["late", "soon", "mid"]
    assert order == ["soon", "mid", "late"]


def test_chunk_scheduler_sheds_expired_chunks(system):
    sched = ChunkScheduler([system.spawn(lambda x: x)])
    with pytest.raises(DeadlineExceeded):
        sched.run([(1,), (2,)], deadlines=[time.monotonic() - 1.0, None])
    assert sched.stats["expired"] == 1
    with pytest.raises(ValueError, match="one deadline"):
        sched.run([(1,)], deadlines=[None, None])


# ----------------------------------------------------------------------------
# pools
# ----------------------------------------------------------------------------
def test_spawn_pool_round_robin_and_scheduler(mngr):
    pool = mngr.spawn_pool(prep, 3, policy="round_robin")
    x = np.arange(N, dtype=np.float32)
    np.testing.assert_allclose(pool.ask(x), x + 1)
    payloads = [(np.full(N, i, np.float32),) for i in range(9)]
    for res in (ChunkScheduler(pool).run(payloads, timeout=60),
                pool.map(payloads, timeout=60)):
        for i, r in enumerate(res):
            np.testing.assert_allclose(r, i + 1)


def test_pool_map_earliest_deadline_first(system):
    order = []

    def record(tag):
        order.append(tag)
        return tag

    pool = ActorPool(system, [system.spawn(record)])
    now = time.monotonic()
    assert pool.map([("b",), ("a",)], deadlines=[now + 20, now + 10]) == \
        ["b", "a"]
    assert order == ["a", "b"]


# ----------------------------------------------------------------------------
# Graph.map_over
# ----------------------------------------------------------------------------
def test_map_over_chunks_through_scheduler(system, ref_baseline):
    g = Graph(system, name="mapped")
    x = g.source("x", torch.float32)
    m = g.map_over(prep, x, chunks=4, replicas=3, min_chunk_bytes=0)
    g.output(g.apply(double, m))
    built = g.build()
    xs = np.arange(64, dtype=np.float32)
    reset_transfer_stats()
    np.testing.assert_allclose(built.ask(xs), (xs + 1) * 2)
    # chunk slices, per-chunk results and the concat stay on the device
    assert transfer_count() == 0
    assert_refs_settle(ref_baseline)


def test_map_over_matches_the_jax_graph():
    xs = np.random.default_rng(0).standard_normal((40, 3)).astype(np.float32)
    jprep = jcore.kernel(jcore.In(jnp.float32), jcore.Out(jnp.float32),
                         name="prep")(lambda x: x + 1.0)
    with jcore.ActorSystem(max_workers=4) as jsys:
        g = jcore.Graph(jsys, name="jmap")
        g.output(g.map_over(jprep, g.source("x", jnp.float32), chunks=3,
                            replicas=2, min_chunk_bytes=0))
        want = np.asarray(g.build().ask(xs))
    with ActorSystem(max_workers=4, device="cpu") as tsys:
        g = Graph(tsys, name="tmap")
        g.output(g.map_over(prep, g.source("x", torch.float32), chunks=3,
                            replicas=2, min_chunk_bytes=0))
        got = g.build().ask(xs)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_map_over_without_speculation_dispatches_each_chunk_once(
        system, monkeypatch):
    """``straggler_factor=inf``, passed through ``map_over`` to its
    ChunkScheduler, turns speculative re-issue off: a lagging chunk is
    waited for, and exactly ``chunks`` chunks are dispatched."""
    made = []

    class Recording(ChunkScheduler):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(scheduler_module, "ChunkScheduler", Recording)

    @kernel(In(torch.float32), Out(torch.float32), name="lagging")
    def lagging(x):
        if x.device.type != "meta" and float(x[0]) == 0.0:
            time.sleep(0.3)            # the first chunk lags the others
        return x + 1.0

    g = Graph(system, name="mapnospec")
    g.output(g.map_over(lagging, g.source("x", torch.float32), chunks=4,
                        replicas=3, min_chunk_bytes=0,
                        straggler_factor=float("inf")))
    xs = np.arange(64, dtype=np.float32)
    np.testing.assert_allclose(g.build().ask(xs), xs + 1)
    assert len(made) == 1 and made[0].straggler_factor == float("inf")
    assert made[0].stats == {"dispatched": 4, "speculative": 0, "failed": 0,
                             "expired": 0}


def test_map_over_small_input_takes_one_chunk(system):
    calls = []

    @kernel(In(torch.float32), Out(torch.float32), name="count_calls")
    def count_calls(x):
        calls.append(x.shape[0])
        return x

    g = Graph(system, name="mapsmall")
    g.output(g.map_over(count_calls, g.source("x", torch.float32), chunks=4))
    g.build().ask(np.zeros(64, np.float32))
    assert calls == [64]


def test_map_over_rejects_multi_arg_kernels(system):
    g = Graph(system, name="mapbad")
    x = g.source("x", torch.float32)
    with pytest.raises(GraphError, match="exactly one input"):
        g.map_over(add2, x)


def test_map_over_rejects_preprocess_kernels(system):
    pre = prep.with_options(preprocess=lambda x: x * 2.0)
    g = Graph(system, name="mappre")
    x = g.source("x", torch.float32)
    with pytest.raises(GraphError, match="mappre/.*preprocess"):
        g.map_over(pre, x)


def test_map_over_rejects_non_kernels(system):
    g = Graph(system, name="mapfn")
    with pytest.raises(GraphError, match="needs a @kernel"):
        g.map_over(lambda x: x, g.source("x", torch.float32))


def test_map_over_empty_input(system):
    """An empty leading axis flows one empty chunk through the kernel."""
    g = Graph(system, name="mapempty")
    g.output(g.map_over(prep, g.source("x", torch.float32), chunks=4,
                        replicas=2))
    out = g.build().ask(np.zeros((0,), np.float32))
    assert out.shape == (0,) and out.dtype == np.float32


def test_map_over_typed_port_checks_the_edge(system):
    from repro_torch.core import PortTypeMismatchError
    g = Graph(system, name="maptyped")
    x = g.source("x", torch.int32)
    g.output(g.map_over(prep, x))
    with pytest.raises(PortTypeMismatchError, match="maptyped/map_prep"):
        g.build()
