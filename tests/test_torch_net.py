"""The port's network layer (``repro_torch.net``) on the CPU, case for case
with ``tests/test_net.py``, and held against the JAX package.

Most tests run two :class:`NodeRuntime`\\ s **in one process** over a
localhost socket, both on ``ActorSystem(device="cpu")`` — that exercises
the full wire path (framing, spill boundary, broker, supervision relays,
heartbeats) fast. The process-wide ref registry is shared between such
nodes, so counter assertions check *deltas across both sides*. The
``slow``-marked tests use a real second process (per-process registries,
SIGKILL node death), started by the ``spawn`` method.

Where ``tests/test_net.py`` kills a node on a timer, the port's case
kills it from inside the remote behavior, so the death always lands
mid-run. Added: the int8 codec bit-exact with ``repro.dist.collectives``
(exact .5 ties included), and ``wire`` round trips of f32, int32 and
bf16 tensor leaves and ``DeviceRef``\\ s, raw and compressed, against the
JAX wire on the same numpy inputs.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import DeviceRef as JDeviceRef
from repro.dist.collectives import dequantize_ref as jdequantize_ref
from repro.dist.collectives import quantize_ref as jquantize_ref
from repro.net import wire as jwire
from repro_torch.core import (ActorFailed, ActorPool, ActorSystem,
                              ChunkScheduler, DeviceRef, DownMessage,
                              ExitMessage, memory_stats, reset_transfer_stats)
from repro_torch.core.actor import Actor
from repro_torch.dist.collectives import dequantize_ref, quantize_ref
from repro_torch.net import NodeDown, NodeRuntime, RemoteActorRef, wire

CPU = "cpu"


# -- module-level behaviors (spawn_remote pickles by reference) --------------
def remote_triple(x):
    return x * 3


def remote_ref_inc(ref):
    return DeviceRef(ref.array + 1)


def remote_device(ref):
    return str(ref.device)


def put(x, **kw):
    return DeviceRef.put(x, device=CPU, **kw)


def decode(data):
    return wire.decode(data, device=CPU)


def cpu_system(name, max_workers=4, **kw):
    return ActorSystem(name, max_workers=max_workers, device=CPU, **kw)


@pytest.fixture()
def pair():
    sa = cpu_system("node-a")
    sb = cpu_system("node-b")
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


def wait_until(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.02)
    return pred()


# ----------------------------------------------------------------------------
# wire format
# ----------------------------------------------------------------------------
def test_wire_roundtrip_plain_containers():
    obj = ("tag", [1, 2.5, "s"], {"k": (None, True)}, np.arange(3))
    out = decode(wire.encode(obj))
    assert out[0] == "tag" and out[1] == [1, 2.5, "s"]
    assert out[2]["k"] == (None, True)
    np.testing.assert_array_equal(out[3], np.arange(3))


def test_wire_request_payload_spill_is_a_copy():
    reset_transfer_stats()
    ref = put(np.arange(8, dtype=np.float32))
    data = wire.encode((ref,))          # request direction: clone
    assert not ref.is_spilled           # sender keeps residency for replay
    out = decode(data)
    np.testing.assert_array_equal(out[0].to_value(), ref.to_value())
    stats = memory_stats()
    assert stats["spills"] == 1 and stats["unspills"] == 1


def test_wire_reply_spill_consumes():
    ref = put(np.arange(8, dtype=np.float32))
    wire.encode((ref,), consume=True)   # reply direction: ownership moves
    assert ref.is_spilled


def test_wire_already_spilled_ref_travels_without_extra_spill():
    ref = put(np.arange(8, dtype=np.float32)).spill()
    reset_transfer_stats()
    out = decode(wire.encode((ref,)))
    stats = memory_stats()
    assert stats["spills"] == 0 and stats["unspills"] == 1
    assert not out[0].is_spilled


def test_wire_int8_compression_shrinks_and_bounds_error():
    x = np.random.RandomState(0).randn(2048).astype(np.float32)
    ref = put(x)
    raw = wire.encoded_size((ref,))
    comp = wire.encoded_size((ref,), compress=True)
    assert comp < raw / 2.5, (raw, comp)
    out = decode(wire.encode((ref,), compress=True))
    got = out[0].to_value()
    assert got.dtype == np.float32
    rel = np.max(np.abs(got - x)) / np.max(np.abs(x))
    assert rel <= 1 / 120


def test_wire_compression_skips_integer_refs():
    ref = put(np.arange(16, dtype=np.int32))
    out = decode(wire.encode((ref,), compress=True))
    np.testing.assert_array_equal(out[0].to_value(), np.arange(16))
    assert out[0].to_value().dtype == np.int32


# ----------------------------------------------------------------------------
# two nodes, one process: messaging
# ----------------------------------------------------------------------------
def test_remote_lookup_ask(pair):
    sa, sb, na, nb = pair
    nb.publish("double", sb.spawn(lambda x: x * 2))
    ref = na.remote_actor("b", "double")
    assert isinstance(ref, RemoteActorRef)
    assert ref.ask(21) == 42
    assert ref.is_alive()


def test_remote_send_fire_and_forget(pair):
    sa, sb, na, nb = pair
    seen, evt = [], threading.Event()
    nb.publish("sink", sb.spawn(lambda x: (seen.append(x), evt.set())))
    ref = na.remote_actor("b", "sink")
    ref.send("hello")
    assert evt.wait(10)
    assert seen == ["hello"]


def test_remote_spawn_and_publish(pair):
    sa, sb, na, nb = pair
    ref = na.spawn_remote("b", remote_triple, publish="triple")
    assert ref.ask(5) == 15
    again = na.remote_actor("b", "triple")
    assert again.remote_id == ref.remote_id


def test_lookup_unknown_name_raises(pair):
    sa, sb, na, nb = pair
    with pytest.raises(LookupError, match="publishes no actor"):
        na.remote_actor("b", "nope")


def test_remote_ref_hop_spills_once_per_hop(pair):
    sa, sb, na, nb = pair
    nb.publish("inc", sb.spawn(remote_ref_inc))
    ref = na.remote_actor("b", "inc")
    d = put(np.arange(4, dtype=np.float32))
    reset_transfer_stats()
    out = ref.ask(d)
    # request hop: 1 spill (driver) + 1 unspill (worker); reply hop: 1 + 1.
    # Shared in-process registry → assert the sum over both sides.
    stats = memory_stats()
    assert stats["spills"] == 2 and stats["unspills"] == 2, stats
    assert not d.is_spilled        # request payloads are spill *copies*
    np.testing.assert_array_equal(out.to_value(),
                                  np.arange(4, dtype=np.float32) + 1)


def test_remote_request_failure_propagates(pair):
    sa, sb, na, nb = pair
    nb.publish("bad", sb.spawn(lambda: 1 / 0))
    ref = na.remote_actor("b", "bad")
    with pytest.raises(ZeroDivisionError):
        ref.ask()
    # the runtime-level refusal after death marks the remote dead
    with pytest.raises(ActorFailed):
        ref.ask()
    assert not ref.is_alive()


# ----------------------------------------------------------------------------
# cross-node supervision
# ----------------------------------------------------------------------------
def test_remote_monitor_delivers_down(pair):
    sa, sb, na, nb = pair
    nb.publish("victim", sb.spawn(lambda: 1 / 0))
    ref = na.remote_actor("b", "victim")
    inbox, got = [], threading.Event()
    w = sa.spawn(lambda m: (inbox.append(m), got.set()))
    sa.monitor(w, ref)            # network-transparent dispatch
    ref.send()
    assert got.wait(10)
    assert isinstance(inbox[0], DownMessage)
    assert inbox[0].actor_id == ref.actor_id
    assert isinstance(inbox[0].reason, ZeroDivisionError)
    assert not ref.is_alive()


def test_monitor_already_dead_remote_fires_immediately(pair):
    sa, sb, na, nb = pair
    victim = sb.spawn(lambda x: x)
    nb.publish("gone", victim)
    ref = na.remote_actor("b", "gone")
    victim.exit(None)
    inbox, got = [], threading.Event()
    w = sa.spawn(lambda m: (inbox.append(m), got.set()))
    sa.monitor(w, ref)
    assert got.wait(10)
    assert isinstance(inbox[0], DownMessage)


def test_remote_link_kills_local_on_remote_death(pair):
    sa, sb, na, nb = pair
    nb.publish("victim", sb.spawn(lambda: 1 / 0))
    ref = na.remote_actor("b", "victim")
    local = sa.spawn(lambda x: x)
    sa.link(local, ref)           # dispatches through the remote ref
    ref.send()
    assert wait_until(lambda: not local.is_alive())


def test_remote_link_trapper_receives_exit(pair):
    sa, sb, na, nb = pair

    class Trapper(Actor):
        def __init__(self):
            super().__init__()
            self.trap_exit = True
            self.exits = []
            self.got = threading.Event()

        def receive(self, msg):
            if isinstance(msg, ExitMessage):
                self.exits.append(msg)
                self.got.set()

    nb.publish("victim", sb.spawn(lambda: 1 / 0))
    ref = na.remote_actor("b", "victim")
    trapper = Trapper()
    t = sa.spawn(trapper)
    sa.link(t, ref)
    ref.send()
    assert trapper.got.wait(10)
    assert trapper.exits[0].actor_id == ref.actor_id


def test_remote_link_reverse_kills_remote_on_local_death(pair):
    sa, sb, na, nb = pair
    victim = sb.spawn(lambda x: x)
    nb.publish("v", victim)
    ref = na.remote_actor("b", "v")
    local = sa.spawn(lambda: 1 / 0)
    sa.link(ref, local)
    local.send()
    assert wait_until(lambda: not victim.is_alive())


# ----------------------------------------------------------------------------
# peer death
# ----------------------------------------------------------------------------
def test_peer_death_fails_pending_and_notifies(pair):
    sa, sb, na, nb = pair
    started, release = threading.Event(), threading.Event()

    def slow(x):
        started.set()
        release.wait(10)
        return x

    nb.publish("slow", sb.spawn(slow))
    ref = na.remote_actor("b", "slow")
    inbox, got = [], threading.Event()
    w = sa.spawn(lambda m: (inbox.append(m), got.set()))
    sa.monitor(w, ref)
    fut = ref.request(1)
    try:
        assert started.wait(10)   # the request is on node b
        nb._conns["a"].sock.close()   # abrupt death (simulated crash)
        with pytest.raises(NodeDown):
            fut.result(timeout=10)
    finally:
        release.set()
    assert got.wait(10)
    assert isinstance(inbox[0], DownMessage)
    assert inbox[0].actor_id == ref.actor_id
    assert isinstance(inbox[0].reason, NodeDown)
    assert not ref.is_alive()
    with pytest.raises(ActorFailed):
        ref.ask(2, timeout=5)


def test_scheduler_reissues_dead_node_chunks_exactly_once(pair):
    sa, sb, na, nb = pair

    def remote_chunk(i):
        # node b dies while it holds this chunk: its reply never leaves
        nb._conns["a"].sock.close()
        return ("remote", i)

    nb.publish("w", sb.spawn(remote_chunk))
    remote = na.remote_actor("b", "w")
    local = sa.spawn(lambda i: (time.sleep(0.02), ("local", i))[1])
    pool = ActorPool(sa, [local, remote])
    sched = ChunkScheduler(pool, max_attempts=4)
    results = sched.run([(i,) for i in range(16)], timeout=60)
    assert sorted(i for _, i in results) == list(range(16))
    assert {src for src, _ in results} == {"local"}
    assert not remote.is_alive()


def test_pool_round_robin_spreads_over_remote_members(pair):
    sa, sb, na, nb = pair
    hits = {"local": 0, "remote": 0}
    nb.publish("w", sb.spawn(lambda x: "remote"))
    remote = na.remote_actor("b", "w")
    local = sa.spawn(lambda x: "local")
    pool = ActorPool(sa, [local, remote], policy="round_robin")
    # payload carries a device-resident ref no member's placement matches:
    # round-robin pools fall back to round-robin, not fake load ranking
    for _ in range(6):
        hits[pool.ask(put(np.arange(2, dtype=np.float32)))] += 1
    assert hits["local"] == 3 and hits["remote"] == 3, hits


def test_node_shutdown_is_graceful_down(pair):
    sa, sb, na, nb = pair
    nb.publish("x", sb.spawn(lambda v: v))
    ref = na.remote_actor("b", "x")
    inbox, got = [], threading.Event()
    w = sa.spawn(lambda m: (inbox.append(m), got.set()))
    sa.monitor(w, ref)
    nb.shutdown()
    assert got.wait(10)
    assert isinstance(inbox[0], DownMessage)
    assert not ref.is_alive()


# ----------------------------------------------------------------------------
# two real processes (slow job)
# ----------------------------------------------------------------------------
@pytest.mark.slow
def test_two_process_pipeline_demo():
    """The acceptance demo on the CPU: 3-stage cross-node pipeline with
    one compressed spill/unspill pair per hop asserted on both
    per-process registries, then SIGKILL mid-run → DownMessage +
    exactly-once."""
    from repro_torch.net import demo
    summary = demo.main(n=1024, chunks=10, compress=True, timeout=120.0,
                        device=CPU)
    assert summary["driver_stats"]["spills"] == 1
    assert summary["worker_stats"]["unspills"] == 1
    assert summary["sources"] >= {"local"}


@pytest.mark.slow
def test_two_process_generic_worker_spawn_remote():
    """A bare ``repro_torch.launch.node`` worker is populated from the
    driver via spawn_remote (behavior pickled by reference); refs it is
    sent land on the device it was asked to bind."""
    import multiprocessing as mp

    from repro_torch.launch.node import run_worker

    system = cpu_system("driver", max_workers=8)
    node = NodeRuntime(system, name="driver", listen=("127.0.0.1", 0))
    ctx = mp.get_context("spawn")
    child = ctx.Process(target=run_worker, args=(node.address, "generic"),
                        kwargs={"device": CPU}, daemon=True)
    child.start()
    try:
        assert node.wait_for_peer("generic", 120)
        ref = node.spawn_remote("generic", remote_triple, timeout=60)
        assert ref.ask(7, timeout=60) == 21
        where = node.spawn_remote("generic", remote_device, timeout=60)
        assert where.ask(put(np.ones(2, np.float32)), timeout=60) == "cpu"
        assert node.peer_stats("generic", timeout=60)["device"] == "cpu"
    finally:
        node.shutdown()
        system.shutdown()
        if child.is_alive():
            child.kill()
        child.join(timeout=30)
    assert not child.is_alive()


# ----------------------------------------------------------------------------
# transport robustness
# ----------------------------------------------------------------------------
def test_undecodable_payload_fails_only_that_request(pair):
    """A payload blob the receiver cannot decode (e.g. a __main__-defined
    spawn_remote behavior) must fail its own request with PayloadError —
    not tear down the connection or mark the target actor dead."""
    from repro_torch.net import PayloadError

    sa, sb, na, nb = pair
    nb.publish("ok", sb.spawn(lambda x: x + 1))
    ref = na.remote_actor("b", "ok")
    fut = na._pending_request(
        "b", ref.remote_id,
        lambda rid: ("request", rid, ref.remote_id, b"\x80not-a-pickle"))
    with pytest.raises(PayloadError):
        fut.result(10)
    assert ref.is_alive()            # not marked dead
    assert ref.ask(1, timeout=10) == 2   # connection still healthy


def test_unencodable_request_payload_fails_future_not_caller(pair):
    """A payload that cannot even be encoded locally (function-scoped
    class) fails the returned future instead of raising into the caller
    (the scheduler dispatch path relies on failures surfacing there)."""
    sa, sb, na, nb = pair
    nb.publish("ok", sb.spawn(lambda x: x))
    ref = na.remote_actor("b", "ok")

    class Unpicklable:               # function-scoped: pickle refuses
        pass

    fut = ref.request(Unpicklable())
    with pytest.raises(Exception):
        fut.result(10)
    assert ref.ask(3, timeout=10) == 3


def test_reconnect_clears_stale_death_state(pair):
    """A restarted same-named peer is a fresh incarnation: its actor ids
    restart at 1, so per-actor death state from the dead incarnation must
    not shadow the new one."""
    sa, sb, na, nb = pair
    nb.publish("x", sb.spawn(lambda v: v))
    ref = na.remote_actor("b", "x")
    nb._conns["a"].sock.close()      # incarnation 1 dies
    assert wait_until(lambda: not ref.is_alive())

    sb2 = cpu_system("node-b2", max_workers=2)
    nb2 = NodeRuntime(sb2, name="b")   # same node name, new process-alike
    try:
        nb2.connect(na.address)
        assert na.wait_for_peer("b", 10)
        nb2.publish("x", sb2.spawn(lambda v: v * 2))
        ref2 = na.remote_actor("b", "x")
        assert ref2.is_alive()       # would be False with stale _dead_remote
        assert ref2.ask(4, timeout=10) == 8
    finally:
        nb2.shutdown()
        sb2.shutdown()


def test_delegated_failure_does_not_mark_remote_dead(pair):
    """A remote actor that delegates to a dead actor replies ActorFailed
    while staying alive itself — the requester must key death off the
    reply's liveness flag, not the error type."""
    sa, sb, na, nb = pair
    dead_inner = sb.spawn(lambda x: x)
    dead_inner.exit(None)
    forwarder = sb.spawn(lambda x: dead_inner.request(x))
    nb.publish("fw", forwarder)
    ref = na.remote_actor("b", "fw")
    with pytest.raises(ActorFailed):
        ref.ask(1, timeout=10)
    assert forwarder.is_alive()
    assert ref.is_alive()            # healthy replica must not be dropped


def test_wire_compression_preserves_access_rights():
    """The int8 wire path must not widen a restricted view back to rw."""
    ref = put(np.random.RandomState(1).randn(64)
              .astype(np.float32)).restrict("r")
    out = decode(wire.encode((ref,), compress=True))
    assert out[0].access == "r"


def test_actor_ref_refuses_pickle():
    """Process-local handles refuse the wire with an actionable message,
    mirroring the DeviceRef explicit-spill policy."""
    import pickle

    s = cpu_system("pickle-guard", max_workers=2)
    try:
        ref = s.spawn(lambda x: x)
        with pytest.raises(TypeError, match="process-local"):
            pickle.dumps(ref)
    finally:
        s.shutdown()


# ----------------------------------------------------------------------------
# runtime-loop regressions
# ----------------------------------------------------------------------------
def test_shutdown_returns_promptly_despite_long_heartbeat_interval():
    """shutdown() must not linger in the heartbeat loop's sleep: the loop
    waits on an Event that shutdown sets, so a node with a 5 s interval
    still leaves in milliseconds."""
    s = cpu_system("hb-shutdown", max_workers=2)
    node = NodeRuntime(s, name="hb", heartbeat_interval=5.0)
    try:
        time.sleep(0.05)             # heartbeat thread is mid-wait now
        t0 = time.monotonic()
        node.shutdown()
        elapsed = time.monotonic() - t0
        assert elapsed < 0.5, f"shutdown took {elapsed:.2f}s"
        assert not node._hb_thread.is_alive()   # joined, not abandoned
    finally:
        node.shutdown()
        s.shutdown()


def test_peer_stats_timeout_honors_node_config():
    """peer_stats defaults its timeout from the node's rpc_timeout (itself
    from the system's default_ask_timeout), and the TimeoutError names
    the unresponsive peer and its last-rx age."""
    from concurrent.futures import TimeoutError as FuturesTimeout

    sa = cpu_system("rpc-a", max_workers=2)
    sb = cpu_system("rpc-b", max_workers=2)
    na = NodeRuntime(sa, name="a", listen=("127.0.0.1", 0),
                     rpc_timeout=0.3)
    nb = NodeRuntime(sb, name="b")
    try:
        nb.connect(na.address)
        assert na.wait_for_peer("b", 10)
        nb._on_rpc = lambda *a, **k: None     # b goes mute on rpcs
        t0 = time.monotonic()
        with pytest.raises(FuturesTimeout) as ei:
            na.peer_stats("b")
        elapsed = time.monotonic() - t0
        assert elapsed < 5.0, f"configured 0.3s timeout took {elapsed:.2f}s"
        msg = str(ei.value)
        assert "'b'" in msg and "last rx" in msg and "0.3" in msg, msg
        # an explicit per-call timeout still overrides the node default
        t0 = time.monotonic()
        with pytest.raises(FuturesTimeout):
            na.peer_stats("b", timeout=0.1)
        assert time.monotonic() - t0 < 5.0
    finally:
        na.shutdown()
        nb.shutdown()
        sa.shutdown()
        sb.shutdown()


def test_rpc_timeout_inherits_system_default_ask_timeout():
    s = cpu_system("rpc-default", max_workers=2, default_ask_timeout=7.5)
    node = NodeRuntime(s, name="n")
    try:
        assert node.rpc_timeout == 7.5
    finally:
        node.shutdown()
        s.shutdown()


def test_stats_provider_merges_and_survives_broken_provider(pair):
    sa, sb, na, nb = pair
    nb.add_stats_provider("good", lambda: {"v": 1})
    nb.add_stats_provider("bad", lambda: 1 / 0)
    snap = na.peer_stats("b", timeout=30)
    assert snap["good"] == {"v": 1}
    assert "error" in snap["bad"]          # one broken provider is isolated
    assert "spills" in snap                # base memory_stats still present


# ----------------------------------------------------------------------------
# held against the JAX package
# ----------------------------------------------------------------------------
def codec_inputs():
    rng = np.random.default_rng(0)
    return {
        "normal": rng.standard_normal(4096).astype(np.float32),
        # absmax 127 → scale 1: every x.5 is an exact tie, rounded to even
        "ties": np.array([127, 2.5, -2.5, 0.5, -0.5, 1.5, 3.5, -126.5,
                          126.5, 64.5], np.float32),
        # absmax 254 → scale 2: odd integers are ties after the division
        "ties_scaled": np.array([254, 5, -5, 3, 1, 7, -1, 253],
                                np.float32),
        "zeros": np.zeros(7, np.float32),
        "tiny": (rng.standard_normal(1000) * 1e-30).astype(np.float32),
        "wide": (rng.standard_normal(513) * 1e6).astype(np.float32),
    }


@pytest.mark.parametrize("case", sorted(codec_inputs()))
def test_int8_codec_bit_exact_with_jax(case):
    x = codec_inputs()[case]
    jq, jscale = jquantize_ref(x)
    q, scale = quantize_ref(torch.from_numpy(x))
    assert q.dtype == torch.int8 and q.device.type == "cpu"
    assert scale == jscale
    np.testing.assert_array_equal(q.to_value(), np.asarray(jq.to_value()))
    for dt, jdt in ((torch.float32, np.float32),
                    (torch.bfloat16, "bfloat16")):
        got = dequantize_ref(q, scale, dtype=dt)
        want = np.asarray(jdequantize_ref(jq, jscale, dtype=jdt).array)
        assert got.dtype == dt
        np.testing.assert_array_equal(
            got.array.float().numpy().view(np.uint32),
            want.astype(np.float32).view(np.uint32))


WIRE_DTYPES = {"float32": torch.float32, "int32": torch.int32,
               "bfloat16": torch.bfloat16}


def wire_input(name):
    x = np.random.default_rng(3).standard_normal((4, 33)) * 50
    return torch.from_numpy(x).to(WIRE_DTYPES[name])


def bits(t: torch.Tensor) -> np.ndarray:
    """The raw bits of a CPU tensor (bfloat16 through an int16 view)."""
    t = t.contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


@pytest.mark.parametrize("name", sorted(WIRE_DTYPES))
def test_wire_tensor_leaves_travel_by_value_in_their_dtype(name):
    x = wire_input(name)
    big = torch.cat([x] * 8)
    view = big[2:6]                          # a view of a larger storage
    # the view ships its own elements, not the storage under it
    assert len(wire.encode(view)) < big.nbytes // 2
    data = wire.encode(("t", x, [view], {"k": x[:, 1]}))
    out = decode(data)
    for got, want in ((out[1], x), (out[2][0], view), (out[3]["k"], x[:, 1])):
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("name", sorted(WIRE_DTYPES))
def test_wire_refs_round_trip_like_the_jax_wire(name, compress):
    """A ref sent raw comes back bit for bit; sent compressed, a float ref
    comes back exactly as the JAX wire's compressed f32 ref does on the
    same numpy values (bf16 through the same codec, rounded once)."""
    x = wire_input(name)
    ref = DeviceRef(x.clone(), access="r")
    out = decode(wire.encode((ref,), compress=compress))[0]
    assert isinstance(out, DeviceRef) and out.device.type == "cpu"
    assert out.dtype == x.dtype and out.shape == tuple(x.shape)
    assert out.access == "r" and not ref.is_spilled
    got = out.array
    if not compress or name == "int32":
        np.testing.assert_array_equal(bits(got), bits(x))
        return
    jref = JDeviceRef.put(x.float().numpy())
    want = np.array(jwire.decode(jwire.encode((jref,), compress=True))[0]
                    .to_value())
    np.testing.assert_array_equal(
        got.float().numpy(),
        torch.from_numpy(want).to(x.dtype).float().numpy())
