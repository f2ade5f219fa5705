"""The port's serve runtime on the CPU, case for case with
``tests/test_serve.py``, and held against the JAX package.

Covers: batcher policies (max-wait vs max-batch, shape bucketing, the
windowless join path), queue ordering and admission control
(backpressure, load shedding, SLO budget), ``LatencyStats`` and ``EWMA``
against the JAX package's on the same samples, the engine on a toy
counter model (every request gets exactly its own tokens, joins, a
16-thread hammer, deadline shedding with no leaked refs, worker crashes
replayed exactly once, self-healing, per-request permanent failures, a
graph decode step), the launcher's cache-capacity guard, a ``ServeEngine``
run of the qwen3-1.7b smoke model whose tokens equal the JAX
``ServeEngine``'s on the same converted parameters, and
``launch.serve.main`` in engine, sync and paged modes on the CPU.

Every future is waited on with a timeout and every engine stops in a
``finally`` (its context manager); no test asserts on wall time beyond
the batcher windows ``tests/test_serve.py`` asserts on.
"""
import gc
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.core import ActorSystem as JActorSystem
from repro.dist.step import build_serve_step as jbuild_serve_step
from repro.models import Model as JModel
from repro.serve import EWMA as JEWMA
from repro.serve import LatencyStats as JLatencyStats
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core import (ActorPool, ActorSystem, DeadlineExceeded, Graph,
                              In, NDRange, Out, dim_vec, kernel,
                              live_ref_count, transfer_count)
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.serve import check_cache_capacity, run_engine, run_sync
from repro_torch.models import Model
from repro_torch.serve import (EWMA, Batcher, LatencyStats, QueueOverflow,
                               Request, RequestQueue, ServeEngine,
                               SLOExceeded, make_decode_worker)

ARCH = "qwen3-1.7b"
WAIT = 60


@pytest.fixture(scope="module")
def system():
    s = ActorSystem(max_workers=8, device="cpu")
    yield s
    s.shutdown()


# ----------------------------------------------------------------------------
# toy decode model: cache row = [seed, step]; token = seed*1000 + step
# ----------------------------------------------------------------------------
def counter_step(cache, tokens):
    next_tok = (cache[:, 0] * 1000 + cache[:, 1]).to(torch.int32)
    return next_tok, cache + torch.tensor([0, 1], dtype=cache.dtype)


def counter_init(prompt):
    return torch.tensor([int(prompt), 0], dtype=torch.int32), 0


def expected_tokens(seed, n):
    return [seed * 1000 + i for i in range(n)]


def make_engine(system, **kw):
    kw.setdefault("n_workers", 2)
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_wait_ms", 2.0)
    return ServeEngine(system, counter_step, counter_init, **kw)


# ----------------------------------------------------------------------------
# batcher policies
# ----------------------------------------------------------------------------
def test_batcher_max_batch_returns_without_waiting_window():
    q = RequestQueue()
    for s in range(8):
        q.submit(Request(s, max_new_tokens=1))
    b = Batcher(q, max_batch=8, max_wait_ms=10_000.0)
    t0 = time.monotonic()
    batch = b.take(wait_s=0.0)
    assert len(batch) == 8
    assert time.monotonic() - t0 < 5.0  # full batch short-circuits 10 s


def test_batcher_max_wait_dispatches_partial_batch():
    q = RequestQueue()
    for s in range(3):
        q.submit(Request(s, max_new_tokens=1))
    b = Batcher(q, max_batch=8, max_wait_ms=30.0)
    t0 = time.monotonic()
    batch = b.take(wait_s=0.0)
    assert len(batch) == 3          # went with what it had...
    assert time.monotonic() - t0 >= 0.025   # ...after the window closed
    assert len(q) == 0


def test_batcher_window_admits_late_arrivals():
    q = RequestQueue()
    q.submit(Request(0, max_new_tokens=1))
    b = Batcher(q, max_batch=4, max_wait_ms=500.0)

    def late():
        time.sleep(0.05)
        for s in (1, 2, 3):
            q.submit(Request(s, max_new_tokens=1))

    t = threading.Thread(target=late)
    t.start()
    batch = b.take(wait_s=0.0)
    t.join(WAIT)
    assert [r.prompt for r in batch] == [0, 1, 2, 3]


def test_batcher_shape_bucketing():
    q = RequestQueue()
    a1 = Request(np.zeros(3), max_new_tokens=1)
    b1 = Request(np.zeros(5), max_new_tokens=1)
    a2 = Request(np.ones(3), max_new_tokens=1)
    for r in (a1, b1, a2):
        q.submit(r)
    b = Batcher(q, max_batch=8, max_wait_ms=10.0)
    assert [r.id for r in b.take(wait_s=0.0)] == [a1.id, a2.id]
    assert [r.id for r in b.take(wait_s=0.0)] == [b1.id]
    assert len(q) == 0


def test_batcher_join_path_is_windowless_and_pinned():
    q = RequestQueue()
    match = Request(np.zeros(3), max_new_tokens=1)
    other = Request(np.zeros(5), max_new_tokens=1)
    q.submit(other)
    q.submit(match)
    b = Batcher(q, max_batch=8, max_wait_ms=10_000.0)
    t0 = time.monotonic()
    batch = b.take(4, bucket=(3,), wait_s=0.0, max_wait_s=0.0)
    assert time.monotonic() - t0 < 5.0
    assert [r.id for r in batch] == [match.id]
    assert len(q) == 1  # the other bucket stayed queued


def test_queue_orders_by_priority_then_deadline():
    q = RequestQueue()
    now = time.monotonic()
    low = Request("a", priority=5)
    urgent = Request("b", priority=0, deadline=now + 10)
    more_urgent = Request("c", priority=0, deadline=now + 5)
    for r in (low, urgent, more_urgent):
        q.submit(r)
    assert q.pop(timeout=0).id == more_urgent.id
    assert q.pop(timeout=0).id == urgent.id
    assert q.pop(timeout=0).id == low.id


# ----------------------------------------------------------------------------
# admission control: backpressure + load shedding
# ----------------------------------------------------------------------------
def test_queue_overflow_sheds_nonblocking():
    q = RequestQueue(max_depth=2)
    q.submit(Request(0))
    q.submit(Request(1))
    with pytest.raises(QueueOverflow):
        q.submit(Request(2))
    assert q.shed == 1 and len(q) == 2


def test_queue_backpressure_blocks_until_space():
    q = RequestQueue(max_depth=1)
    q.submit(Request(0))
    admitted = []

    def producer():
        q.submit(Request(1), block=True, timeout=5.0)
        admitted.append(True)

    t = threading.Thread(target=producer)
    t.start()
    time.sleep(0.05)
    assert not admitted          # still backpressured
    assert q.pop(timeout=0) is not None
    t.join(timeout=5.0)
    assert admitted and len(q) == 1


def test_queue_slo_budget_sheds_when_wait_estimate_blows_budget():
    q = RequestQueue(slo_budget_s=0.1)
    q.submit(Request(0))         # no service estimate yet: admitted
    q.note_service_time(1.0)     # engine observed 1s/step
    with pytest.raises(SLOExceeded):
        q.submit(Request(1))
    assert q.shed == 1


def test_queue_sheds_expired_deadline_at_admission():
    q = RequestQueue()
    with pytest.raises(SLOExceeded):
        q.submit(Request(0, deadline=time.monotonic() - 1.0))
    assert q.shed == 1


# ----------------------------------------------------------------------------
# stats: the same samples give the JAX package's summaries
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("maxlen,n", [(100_000, 1), (100_000, 257), (64, 300)])
def test_latency_stats_match_jax(maxlen, n):
    samples = np.random.default_rng(n).exponential(0.01, n)
    ours, theirs = LatencyStats(maxlen=maxlen), JLatencyStats(maxlen=maxlen)
    assert ours.summary() == theirs.summary()
    for s in samples:
        ours.record(s)
        theirs.record(s)
    assert ours.summary() == theirs.summary()
    for p in (0, 50, 95, 99, 100):
        assert ours.percentile(p) == theirs.percentile(p)


def test_ewma_matches_jax():
    ours, theirs = EWMA(alpha=0.3), JEWMA(alpha=0.3)
    assert ours.value is None and theirs.value is None
    for x in (1.0, 0.5, 2.0, 0.25):
        assert ours.update(x) == theirs.update(x)
    with pytest.raises(ValueError):
        EWMA(alpha=0.0)


# ----------------------------------------------------------------------------
# engine: join/leave correctness
# ----------------------------------------------------------------------------
def test_every_request_gets_exactly_its_own_tokens(system):
    lengths = [3, 1, 4, 2, 5, 1, 3, 2, 4, 1]
    with make_engine(system, max_batch=3) as eng:
        futs = [eng.submit(seed, max_new_tokens=n)
                for seed, n in enumerate(lengths)]
        results = [f.result(timeout=WAIT) for f in futs]
    for seed, (n, res) in enumerate(zip(lengths, results)):
        assert res.tokens == expected_tokens(seed, n), f"request {seed}"
    s = eng.stats()
    assert s["completed"] == len(lengths)
    assert s["joined"] == len(lengths) and s["left"] == len(lengths)
    assert s["failed"] == 0


def test_requests_join_a_running_batch(system):
    with make_engine(system, max_batch=2, max_wait_ms=1.0) as eng:
        long_fut = eng.submit(1, max_new_tokens=30)
        time.sleep(0.2)  # the long request is mid-decode by now
        late_futs = [eng.submit(seed, max_new_tokens=2) for seed in (2, 3, 4)]
        assert long_fut.result(WAIT).tokens == expected_tokens(1, 30)
        for seed, f in zip((2, 3, 4), late_futs):
            assert f.result(WAIT).tokens == expected_tokens(seed, 2)
    s = eng.stats()
    assert s["peak_batch"] >= 2
    assert s["steps"] < 30 + 3 * 2  # overlap: fewer steps than serial sum


def test_sixteen_thread_client_hammer(system):
    n_threads, per_thread = 16, 4
    results: dict = {}
    errors: list = []
    with make_engine(system, max_batch=4, max_wait_ms=1.0,
                     n_workers=3) as eng:

        def client(tid):
            try:
                futs = []
                for k in range(per_thread):
                    seed = tid * 100 + k
                    n = 1 + (seed % 5)
                    futs.append((seed, n, eng.submit(seed, max_new_tokens=n)))
                for seed, n, fut in futs:
                    results[(seed, n)] = fut.result(timeout=120)
            except Exception as exc:  # pragma: no cover - failure path
                errors.append(exc)

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
    assert not errors
    assert len(results) == n_threads * per_thread  # none lost
    for (seed, n), res in results.items():
        assert res.tokens == expected_tokens(seed, n), (seed, n)
    assert eng.stats()["completed"] == n_threads * per_thread


def test_engine_leak_free_and_deadline_shedding(system):
    gc.collect()
    base = live_ref_count()
    eng = make_engine(system, max_batch=4)
    ok = eng.submit(7, max_new_tokens=3)
    dead = eng.submit(8, max_new_tokens=3, slo_ms=50.0)
    time.sleep(0.1)
    with eng:
        assert ok.result(WAIT).tokens == expected_tokens(7, 3)
        with pytest.raises(DeadlineExceeded):
            dead.result(WAIT)
    gc.collect()
    assert live_ref_count() == base  # every cache ref released
    assert eng.stats()["expired"] >= 1


def test_failed_cache_init_releases_partial_tree(system):
    class BadLeaf:
        def __array__(self, *a, **k):
            raise RuntimeError("unwrappable cache leaf")

    def bad_init(prompt):
        return (torch.zeros(4), BadLeaf()), 0

    gc.collect()
    base = live_ref_count()
    eng = ServeEngine(system, counter_step, bad_init, n_workers=2,
                      max_batch=4)
    with eng:
        fut = eng.submit(1, max_new_tokens=2)
        with pytest.raises(RuntimeError, match="unwrappable"):
            fut.result(WAIT)
    gc.collect()
    assert live_ref_count() == base  # the good leaf was released
    assert eng.stats()["failed"] == 1


# ----------------------------------------------------------------------------
# fault injection
# ----------------------------------------------------------------------------
def _flaky_pool(system, crashes: int):
    armed = {"left": crashes}
    lock = threading.Lock()
    decode = make_decode_worker(counter_step)

    def flaky(*payload):
        with lock:
            if armed["left"] > 0:
                armed["left"] -= 1
                raise RuntimeError("injected mid-batch fault")
        return decode(*payload)

    workers = [system.spawn(flaky) for _ in range(3)]
    return ActorPool(system, workers, policy="least_loaded")


def test_worker_crash_requeues_batch_exactly_once(system):
    pool = _flaky_pool(system, crashes=1)
    eng = ServeEngine(system, init_fn=counter_init, pool=pool,
                      max_batch=4, max_wait_ms=5.0)
    with eng:
        futs = [eng.submit(seed, max_new_tokens=3) for seed in range(6)]
        results = [f.result(timeout=WAIT) for f in futs]
    for seed, res in enumerate(results):
        assert res.tokens == expected_tokens(seed, 3)
    s = eng.stats()
    assert s["requeues"] >= 1
    assert s["completed"] == 6 and s["failed"] == 0
    assert len(pool.live_workers()) == 2  # the crashed replica is gone


def test_engine_owned_pool_self_heals_after_worker_death(system):
    with make_engine(system, n_workers=2, max_batch=4) as eng:
        assert eng.submit(1, max_new_tokens=2).result(WAIT).tokens == \
            expected_tokens(1, 2)
        eng.pool.workers[0].exit()  # simulate a replica crash
        futs = [eng.submit(seed, max_new_tokens=3) for seed in (2, 3)]
        for seed, f in zip((2, 3), futs):
            assert f.result(WAIT).tokens == expected_tokens(seed, 3)
        assert len(eng.pool.live_workers()) == 2  # capacity restored
    assert eng.stats()["respawned"] >= 1


def test_permanent_failure_is_per_request_error_not_engine_crash(system):
    pool = _flaky_pool(system, crashes=99)  # kills all 3 workers
    eng = ServeEngine(system, init_fn=counter_init, pool=pool,
                      max_batch=4, max_wait_ms=5.0, step_timeout=30.0)
    with eng:
        doomed = [eng.submit(seed, max_new_tokens=2) for seed in range(3)]
        for f in doomed:
            with pytest.raises(Exception):
                f.result(timeout=WAIT)
    s = eng.stats()
    assert s["failed"] == 3 and s["completed"] == 0
    assert not eng._thread.is_alive()


def test_serve_engine_with_graph_step(system):
    @kernel(In(torch.int32), In(torch.float32), Out(torch.int32),
            Out(torch.float32, as_ref=True), nd_range=NDRange(dim_vec(4)),
            name="decode_step")
    def decode_step(tok, acc):
        return tok + 1, acc + tok.to(torch.float32)

    g = Graph(system, name="decoder")
    tk = g.source("tokens", torch.int32)
    ac = g.source("acc", torch.float32)
    o_tok, o_acc = g.apply(decode_step, tk, ac)
    g.output(o_tok, o_acc)
    step_graph = g.build()

    def init(prompt):
        return {"acc": torch.zeros(())}, int(prompt)

    with ServeEngine(system, init_fn=init, step_graph=step_graph,
                     n_workers=1, max_batch=4) as eng:
        futs = [eng.submit(i, max_new_tokens=3) for i in range(5)]
        for i, f in enumerate(futs):
            assert f.result(WAIT).tokens == [i + 1, i + 2, i + 3]
    assert eng.stats()["completed"] == 5


def test_engine_validation(system):
    pool = ActorPool(system, [system.spawn(lambda *a: a)])
    with pytest.raises(ValueError, match="adopted pool"):
        ServeEngine(system, init_fn=lambda p: ({}, 0), pool=pool,
                    step_fn=lambda c, t: (t, c))
    with pytest.raises(ValueError, match="init_fn"):
        ServeEngine(system, counter_step)


def test_engine_without_a_card_binds_no_cpu_unasked():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with ActorSystem(max_workers=1) as bare:
        with pytest.raises(LookupError):
            ServeEngine(bare, counter_step, counter_init)


# ----------------------------------------------------------------------------
# launch CLI
# ----------------------------------------------------------------------------
def test_check_cache_capacity_guard():
    assert check_cache_capacity(64, 65) == 65      # steps+1 fits exactly
    with pytest.raises(ValueError):
        check_cache_capacity(65, 65)               # off-by-one caught
    with pytest.raises(ValueError):
        check_cache_capacity(-1, 10)


def test_demo_32_requests_zero_host_transfers_with_latency_report(system):
    n_requests, steps = 32, 4
    eng = make_engine(system, max_batch=8, n_workers=2)
    futs = [eng.submit(seed, max_new_tokens=steps)
            for seed in range(n_requests)]
    t0 = transfer_count()
    with eng:
        results = [f.result(timeout=120) for f in futs]
    assert transfer_count() == t0, \
        "decode caches must stay device-resident between steps"
    for seed, res in enumerate(results):
        assert res.tokens == expected_tokens(seed, steps)
    s = eng.stats()
    assert s["peak_batch"] == 8
    assert s["steps"] == (n_requests // 8) * steps
    assert s["latency"]["count"] == n_requests
    assert 0 < s["latency"]["p50_ms"] <= s["latency"]["p99_ms"]


# ----------------------------------------------------------------------------
# the qwen3-1.7b smoke model served by both packages
# ----------------------------------------------------------------------------
def _jax_engine_tokens(jmodel, jparams, prompts, steps, batch):
    """The JAX launcher's engine mode (``repro/launch/serve.py:40``) with
    per-request first tokens."""
    capacity = steps + 1
    serve_step = jbuild_serve_step(jmodel)

    def step_fn(cache, tokens):
        nxt, _, cache = serve_step(jparams, cache, tokens[:, None])
        return nxt[:, 0], cache

    def init_fn(prompt):
        return jmodel.init_cache(1, capacity), int(prompt)

    s1 = jax.tree_util.tree_leaves(
        jax.eval_shape(lambda: jmodel.init_cache(1, capacity)))
    s2 = jax.tree_util.tree_leaves(
        jax.eval_shape(lambda: jmodel.init_cache(2, capacity)))
    axes = [next((ax for ax, (a, b) in enumerate(zip(x.shape, y.shape))
                  if a != b), None) for x, y in zip(s1, s2)]

    def combine(leaves, i):
        return leaves[0] if axes[i] is None else \
            jnp.concatenate(leaves, axis=axes[i])

    def split(leaf, b, i):
        return leaf if axes[i] is None else \
            jax.lax.slice_in_dim(leaf, b, b + 1, axis=axes[i])

    with JActorSystem(name="jax-serve") as jsystem:
        engine = JServeEngine(jsystem, step_fn, init_fn, n_workers=2,
                              max_batch=batch, allow_join=False,
                              combine=combine, split=split)
        with engine:
            futs = [engine.submit(p, max_new_tokens=steps) for p in prompts]
            return [f.result(timeout=300).tokens for f in futs]


def test_engine_tokens_equal_the_jax_engine():
    jcfg, cfg = jget_smoke(ARCH), get_smoke_config(ARCH)
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.key(11))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    model = Model(cfg, device="cpu")
    prompts = [int(t) for t in np.random.default_rng(11).integers(
        0, cfg.vocab_size, 6)]
    steps = 8
    want = _jax_engine_tokens(jmodel, jparams, prompts, steps, batch=4)
    run = run_engine(model, params, requests=len(prompts), batch=4,
                     steps=steps, workers=2, prompts=prompts, timeout=300)
    got = [[int(t) for t in r.tokens] for r in run["results"]]
    assert got == [[int(t) for t in w] for w in want]
    assert run["stats"]["completed"] == len(prompts)
    assert run["memref_after"]["transfers"] == run["memref_before"]["transfers"]
    # the static-batch loop gives the same tokens for the first batch
    sync = run_sync(model, params, batch=4, steps=steps, prompts=prompts[:4])
    assert sync["tokens"].tolist() == got[:4]


# ----------------------------------------------------------------------------
# launch.serve.main on the CPU
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["engine", "sync", "paged"])
def test_launch_serve_main_on_the_cpu(mode, capsys):
    argv = ["--arch", ARCH, "--device", "cpu", "--requests", "6",
            "--batch", "4", "--steps", "5"]
    argv += {"engine": [], "sync": ["--sync"], "paged": ["--paged"]}[mode]
    assert launch_serve.main(argv) == 0
    out = capsys.readouterr().out
    assert "tok/s" in out and "sample:" in out
    if mode != "sync":
        assert "latency p50=" in out and "requeues=0" in out
    if mode == "paged":
        assert "prefix_hits=" in out and "cow=" in out
