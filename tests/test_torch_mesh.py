"""The port's serve mesh (``repro_torch.serve.mesh``) on the CPU, case for
case with ``tests/test_mesh.py``, and held against the JAX package.

Fast tests run the router over in-process replicas or two in-process
``NodeRuntime``\\ s over a localhost socket, all on
``ActorSystem(device="cpu")``. The ``slow``-marked test is the
acceptance demo: a real 3-process mesh with a worker SIGKILLed
mid-traffic.

The cases are deterministic where ``tests/test_mesh.py``'s hang on
timing:

* a test that is not about scaling sets ``min_replicas`` to its replica
  count, so no scale-in can drain a replica mid-test;
* the prefix-routing case sends ``str`` prompts: an ``int`` prompt has no
  prefix, so ``route_by_prefix`` routes it keyless (``prefix_routed``
  stays 0) and the least-wait pick moves it to the other replica as soon
  as a load poll lands between two requests;
* replicas and nodes are killed when the router shows them holding
  requests in flight, not after a sleep;
* the scale-out and drain-release case replaces the router's clock by a
  fake one and never lets the control loop tick: it drives
  ``_poll_replicas`` and ``_autoscale`` by hand, with an actor-mailbox
  barrier after each poll, and its SLO budget sits well clear of the toy
  replica's step time.

Added: the JAX ``MeshRouter`` and the port's over ``toy_engine`` give the
same tokens and counters, and a mesh of two qwen3-1.7b smoke replicas
gives every request the tokens of one f32 engine.
"""
import time

import pytest

from repro.core import ActorSystem as JActorSystem
from repro.launch.serve_mesh import toy_engine as jtoy_engine
from repro.serve import MeshRouter as JMeshRouter
from repro.serve import ReplicaSpec as JReplicaSpec
from repro_torch.core import ActorSystem
from repro_torch.core.errors import ActorError
from repro_torch.launch.serve_mesh import (expected_tokens, model_engine,
                                           toy_engine)
from repro_torch.net import NodeRuntime
from repro_torch.serve import (AdmissionError, LatencyStats, MeshDown,
                               MeshRouter, ReplicaSpec, local_replica_stats)

WAIT = 60


@pytest.fixture(scope="module")
def system():
    s = ActorSystem("mesh-test", max_workers=8, device="cpu")
    yield s
    s.shutdown()


def make_router(system, n_replicas=2, *, service_delay_s=0.005, **kw):
    spec = ReplicaSpec(toy_engine, service_delay_s=service_delay_s)
    kw.setdefault("control_interval", 0.05)
    kw.setdefault("max_attempts", 4)
    kw.setdefault("min_replicas", n_replicas)
    router = MeshRouter(system, None, spec=spec, **kw)
    for _ in range(n_replicas):
        router.spawn_replica()
    return router


def wait_for(pred, timeout=15.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def inflight(router, rep) -> int:
    return router.stats()["replicas"][rep.key]["inflight"]


# ----------------------------------------------------------------------------
# routing
# ----------------------------------------------------------------------------
def test_routing_spreads_keyless_load(system):
    with make_router(system, 2) as router:
        futs = [router.submit(i, max_new_tokens=2) for i in range(24)]
        for i, f in enumerate(futs):
            assert f.result(WAIT).tokens == expected_tokens(i, 2)
        # both replicas served a share (the inflight term in the pick
        # score balances a tight submit loop even with stale EWMAs)
        loads = [rep.ref.ask("stats", timeout=30)
                 for rep in router._replicas.values()]
        assert all(l["completed"] > 0 for l in loads), loads
        assert sum(l["completed"] for l in loads) == 24


def test_session_affinity_pins_one_replica(system):
    with make_router(system, 3) as router:
        futs = [router.submit(5, max_new_tokens=1, session="sess-X")
                for _ in range(9)]
        for f in futs:
            assert f.result(WAIT).tokens == expected_tokens(5, 1)
        assert len({f.replica for f in futs}) == 1
        loads = [rep.ref.ask("stats", timeout=30)
                 for rep in router._replicas.values()]
        served = sorted(l["completed"] for l in loads)
        assert served == [0, 0, 9], served   # all nine on one replica
        assert router.stats()["prefix_routed"] == 9


def test_prefix_routing_groups_shared_prefixes(system):
    spec = ReplicaSpec(toy_engine, service_delay_s=0.0)
    router = MeshRouter(system, None, spec=spec, route_by_prefix=True,
                        prefix_tokens=4, control_interval=0.05,
                        min_replicas=2)
    with router:
        router.spawn_replica()
        router.spawn_replica()
        # same prompt → same prefix key → same replica, every time
        for _ in range(6):
            res = router.submit("3", max_new_tokens=1).result(WAIT)
            assert res.tokens == expected_tokens(3, 1)
        loads = [rep.ref.ask("stats", timeout=30)
                 for rep in router._replicas.values()]
        assert sorted(l["completed"] for l in loads) == [0, 6]
        assert router.stats()["prefix_routed"] == 6


def test_mesh_down_when_no_replicas(system):
    router = MeshRouter(system, None)
    with pytest.raises(MeshDown):
        router.submit(1).result(10)
    assert router.stats()["failed"] == 1


# ----------------------------------------------------------------------------
# failure transparency
# ----------------------------------------------------------------------------
def test_replica_death_replays_inflight_exactly_once(system):
    """Kill one of two replicas with a deep backlog routed to it: every
    request still completes exactly once with the right tokens, and the
    router's replicas_lost/replayed counters record the event."""
    with make_router(system, 2, service_delay_s=0.05) as router:
        victim = next(iter(router._replicas.values()))
        futs = [router.submit(i, max_new_tokens=4) for i in range(32)]
        # more than a batch (8) is queued on the victim (its first batch
        # takes 4 steps of 50 ms): some are not in its running batch, so
        # they cannot finish before the kill
        assert inflight(router, victim) > 8
        victim.ref.exit(RuntimeError("simulated replica crash"))
        for i, f in enumerate(futs):
            assert f.result(WAIT).tokens == expected_tokens(i, 4)
        assert wait_for(lambda: router.stats()["replicas_lost"] == 1)
        s = router.stats()
        assert s["completed"] == 32, s           # exactly once each
        assert s["failed"] == 0 and s["shed"] == 0, s
        assert s["replayed"] >= 1, s
        assert s["replicas"][victim.key]["state"] == "dead"


def test_all_replicas_dead_fails_requests_with_meshdown(system):
    with make_router(system, 1, service_delay_s=0.05) as router:
        rep = next(iter(router._replicas.values()))
        # more than one max_batch: the overflow sits queued in the dying
        # engine and has nowhere to replay
        futs = [router.submit(i, max_new_tokens=8) for i in range(14)]
        assert inflight(router, rep) > 8
        rep.ref.exit(RuntimeError("boom"))
        outcomes = []
        for f in futs:
            try:
                outcomes.append(("ok", f.result(WAIT)))
            except (MeshDown, ActorError) as exc:
                outcomes.append(("err", exc))
        # nothing hangs; each request resolves exactly once (served by
        # the dying batch or failed) — never silently lost
        assert len(outcomes) == 14
        assert any(kind == "err" for kind, _ in outcomes)


def test_shed_is_not_replayed(system):
    """Admission errors are the overload policy answering, not a replica
    failure: the router forwards them to the caller without replay."""
    with make_router(system, 2, service_delay_s=0.05) as router:
        # deadline already busted at admission → SLOExceeded from the
        # replica's queue; must surface as shed, not burn replay attempts
        fut = router.submit(1, max_new_tokens=2, slo_ms=0.0)
        with pytest.raises(AdmissionError):
            fut.result(WAIT)
        s = router.stats()
        assert s["shed"] == 1 and s["replayed"] == 0, s


# ----------------------------------------------------------------------------
# autoscaling
# ----------------------------------------------------------------------------
def poll(router):
    """One control-loop poll, then a barrier: a local replica answers
    ``stats`` (its reply callback updates the router) before it answers
    the ``ping`` queued behind it."""
    router._poll_replicas()
    for rep in list(router._replicas.values()):
        if rep.state == "live":
            rep.ref.ask("ping", timeout=30)


def test_scale_out_under_load_and_drain_release_when_idle(system):
    """Overload grows the mesh, idleness drains one replica and releases
    it. The router's clock is fake and its control loop never ticks: the
    test polls and scales by hand. The thresholds sit well clear of the
    toy step (10 ms): a backlog of ~40 requests at batch 2 waits ~0.4 s
    (scale out above 0.1 s), an idle replica ~0.01 s (drain below
    0.07 s)."""
    now = [0.0]
    spec = ReplicaSpec(toy_engine, service_delay_s=0.01, max_batch=2)
    router = MeshRouter(system, None, spec=spec, control_interval=3600.0,
                        slo_budget_s=0.1, scale_in_ratio=0.7,
                        min_replicas=1, max_replicas=3, cooldown_s=0.3,
                        max_attempts=4)
    router._clock = lambda: now[0]
    router._last_scale = now[0]
    with router:
        first = router.spawn_replica()
        futs = [router.submit(n, max_new_tokens=4) for n in range(40)]
        futs[0].result(WAIT)       # the replica has timed its steps
        poll(router)
        assert first.wait_estimate() > router.slo_budget_s
        router._autoscale()        # still inside the cooldown: no action
        assert router.stats()["scale_outs"] == 0
        now[0] += router.cooldown_s
        router._autoscale()
        s = router.stats()
        assert s["scale_outs"] == 1, s        # overload grew the mesh
        assert len(router.live_replicas()) == 2
        for n, f in enumerate(futs):
            assert f.result(WAIT).tokens == expected_tokens(n, 4)
        s = router.stats()
        assert s["completed"] == 40, s
        assert s["failed"] == 0 and s["shed"] == 0, s
        # idle: EWMA waits undershoot → drain-then-release scale-in
        for _ in range(12):
            poll(router)
        assert max(router._replicas[k].wait_estimate()
                   for k in router.live_replicas()) < 0.07
        now[0] += router.cooldown_s
        router._autoscale()
        assert router.stats()["scale_ins"] == 1
        assert wait_for(lambda: any(
            v["state"] == "released"
            for v in router.stats()["replicas"].values()), timeout=WAIT)
        s = router.stats()
        # a released replica exited on purpose: it is NOT a lost replica
        # and its death must not synthesize replays
        assert s["replicas_lost"] == 0 and s["replayed"] == 0, s
        assert len(router.live_replicas()) == 1 >= router.min_replicas


# ----------------------------------------------------------------------------
# the mesh over real node runtimes (in-process pair)
# ----------------------------------------------------------------------------
@pytest.fixture()
def pair():
    sa = ActorSystem("mesh-a", max_workers=4, device="cpu")
    sb = ActorSystem("mesh-b", max_workers=4, device="cpu")
    na = NodeRuntime(sa, name="a", listen=("127.0.0.1", 0),
                     heartbeat_interval=0.2, heartbeat_timeout=2.0)
    nb = NodeRuntime(sb, name="b", heartbeat_interval=0.2,
                     heartbeat_timeout=2.0)
    nb.connect(na.address)
    assert na.wait_for_peer("b", 10)
    yield sa, sb, na, nb
    na.shutdown()
    nb.shutdown()
    sa.shutdown()
    sb.shutdown()


def test_remote_replica_and_stats_provider(pair):
    """A replica spawned over the wire serves through the same router
    path, and the hosting node's peer_stats exposes its load snapshot
    via the registered provider."""
    sa, sb, na, nb = pair
    nb.add_stats_provider("serve", local_replica_stats)
    spec = ReplicaSpec(toy_engine, service_delay_s=0.0)
    router = MeshRouter(sa, na, spec=spec, control_interval=0.05)
    with router:
        router.spawn_replica("b")
        futs = [router.submit(i, max_new_tokens=3) for i in range(8)]
        for i, f in enumerate(futs):
            assert f.result(WAIT).tokens == expected_tokens(i, 3)
        snap = na.peer_stats("b", timeout=30)
        assert "serve" in snap, snap
        # the provider registry is process-global (other in-process tests
        # may have left entries): key by this replica's worker-side id
        rep = next(iter(router._replicas.values()))
        load = snap["serve"][str(rep.ref.remote_id)]
        assert load["completed"] == 8, snap["serve"]


def test_node_death_replays_on_surviving_replica(pair):
    """The mesh failure-transparency contract across a real (simulated)
    node death: socket close mid-backlog → NodeDown → in-flight requests
    replay on the surviving local replica, exactly once."""
    sa, sb, na, nb = pair
    spec = ReplicaSpec(toy_engine, service_delay_s=0.05)
    router = MeshRouter(sa, na, spec=spec, control_interval=0.05,
                        max_attempts=4, min_replicas=2)
    with router:
        remote = router.spawn_replica("b")     # remote replica
        router.spawn_replica()                 # local survivor
        futs = [router.submit(i, max_new_tokens=4) for i in range(24)]
        # no request can finish in under 4 steps of 50 ms: those held by
        # the remote replica now are still in flight at its death
        assert inflight(router, remote) > 0
        nb._conns["a"].sock.close()   # abrupt node death (simulated crash)
        for i, f in enumerate(futs):
            assert f.result(WAIT).tokens == expected_tokens(i, 4)
        assert wait_for(lambda: router.stats()["replicas_lost"] == 1)
        s = router.stats()
        assert s["completed"] == 24, s
        assert s["failed"] == 0 and s["shed"] == 0, s
        assert s["replayed"] >= 1, s


# ----------------------------------------------------------------------------
# the router as an actor
# ----------------------------------------------------------------------------
def test_front_end_actor_delegates_to_submit(system):
    with make_router(system, 1, service_delay_s=0.0) as router:
        front = router.actor_ref()
        res = front.ask("serve", 4, {"max_new_tokens": 3}, timeout=WAIT)
        assert res.tokens == expected_tokens(4, 3)
        stats = front.ask("stats", timeout=30)
        assert stats["completed"] >= 1


# ----------------------------------------------------------------------------
# LatencyStats percentile cost
# ----------------------------------------------------------------------------
def test_latency_stats_poll_is_sublinear_under_load():
    """percentile()/summary() read an incrementally maintained sorted
    view — a stats poll against a full 100k reservoir must stay cheap
    (the router polls every replica every scheduling tick)."""
    st = LatencyStats()
    for i in range(100_000):
        st.record((i % 977) * 1e-4)
    t0 = time.perf_counter()
    for _ in range(100):
        st.summary()
        st.percentile(99)
    per_poll = (time.perf_counter() - t0) / 100
    # generous bound: a sort per call costs ~10 ms a poll on a full
    # reservoir; the incremental view is microseconds
    assert per_poll < 1e-3, f"stats poll took {per_poll * 1e3:.2f}ms"
    s = st.summary()
    assert s["count"] == 100_000
    assert s["max_ms"] == pytest.approx(976 * 1e-4 * 1e3)


def test_latency_stats_eviction_keeps_views_consistent():
    st = LatencyStats(maxlen=100)
    for i in range(150):               # crosses the eviction boundary
        st.record(float(i))
    assert st._samples == sorted(st._ordered)   # same multiset
    assert st.summary()["count"] == 150
    assert st.percentile(100) == 149.0
    assert st.percentile(0) == st._ordered[0]


# ----------------------------------------------------------------------------
# acceptance: real 3-process mesh, SIGKILL mid-traffic (slow job)
# ----------------------------------------------------------------------------
@pytest.mark.slow
def test_three_process_mesh_survives_worker_sigkill():
    """Driver + 2 worker processes on the CPU, offered load, one worker
    SIGKILLed while it holds a request in flight. run_demo asserts zero
    lost / duplicated requests and ≥80% RPS recovery internally."""
    from repro_torch.launch.serve_mesh import run_demo

    summary = run_demo(2, rps=30.0, duration_s=5.0, recover_window_s=1.5,
                       timeout=120.0, device="cpu")
    assert summary["lost"] == 0
    assert summary["replicas_lost"] == 1
    assert summary["completed"] == summary["submitted"] == 150
    assert summary["replayed"] >= 1
    pre, during, post = summary["windows"]
    assert post["achieved_rps"] >= 0.8 * pre["achieved_rps"]


# ----------------------------------------------------------------------------
# held against the JAX package, and a real model
# ----------------------------------------------------------------------------
def drive(router, requests):
    futs = [router.submit(p, max_new_tokens=n, session=s)
            for p, n, s in requests]
    return [[int(t) for t in f.result(WAIT).tokens] for f in futs]


def test_mesh_matches_jax_mesh_over_toy_engine(system):
    """The same prompts (half under session keys) through the JAX
    MeshRouter and the port's, both over two toy replicas: the same
    tokens and the same counters."""
    requests = [(i, 1 + i % 4, f"s{i % 3}" if i % 2 else None)
                for i in range(16)]
    keys = ("submitted", "routed", "completed", "failed", "shed",
            "replayed", "replicas_lost", "prefix_routed")
    jsystem = JActorSystem("jax-mesh", max_workers=8)
    try:
        jrouter = JMeshRouter(jsystem, None, min_replicas=2,
                              spec=JReplicaSpec(jtoy_engine,
                                                service_delay_s=0.0))
        with jrouter:
            jrouter.spawn_replica()
            jrouter.spawn_replica()
            want = drive(jrouter, requests)
            jstats = jrouter.stats()
    finally:
        jsystem.shutdown()
    with make_router(system, 2, service_delay_s=0.0) as router:
        got = drive(router, requests)
        stats = router.stats()
    assert got == want
    assert got == [expected_tokens(p, n) for p, n, _ in requests]
    assert {k: stats[k] for k in keys} == {k: jstats[k] for k in keys}
    assert stats["prefix_routed"] == 8


def test_mesh_of_qwen3_smoke_replicas_gives_the_single_engines_tokens(
        system, monkeypatch):
    """Two replicas of the qwen3-1.7b smoke config in f32 (random weights
    from one seed, batch 1): every request gets the tokens one f32
    engine gives the same prompt, wherever the mesh routes it.
    ``model_engine`` builds the published config; here its config lookup
    answers with the smoke config, which this machine can run."""
    from repro_torch import configs
    monkeypatch.setattr(configs, "get_config", configs.get_smoke_config)
    kw = dict(arch="qwen3-1.7b", dtype="float32", seed=0, max_batch=1,
              steps=6)
    prompts = [3, 17, 101, 7, 250, 3, 64, 9]
    with model_engine(system, **kw) as engine:
        want = [[int(t) for t in engine.submit(p, max_new_tokens=6)
                 .result(WAIT).tokens] for p in prompts]
    router = MeshRouter(system, None, spec=ReplicaSpec(model_engine, **kw),
                        min_replicas=2, control_interval=0.05)
    with router:
        router.spawn_replica()
        router.spawn_replica()
        futs = [router.submit(p, max_new_tokens=6) for p in prompts]
        got = [[int(t) for t in f.result(WAIT).tokens] for f in futs]
        served = {f.replica for f in futs}
        s = router.stats()
    assert got == want
    assert len(served) == 2, served          # both replicas served
    assert s["completed"] == len(prompts) and s["failed"] == 0, s
