"""The port's actor runtime, data plane, kernel facade, Pipeline and Graph.

Behaviours carried over from ``tests/test_actor.py``,
``test_memref_plane.py``, ``test_facade.py``, ``test_api.py`` and
``test_graph.py`` for what the first slice ports. Every system here is
created with ``device="cpu"``: the port binds the CPU only when asked.
"""
import gc
import pickle
import threading
import time
from concurrent.futures import TimeoutError as FuturesTimeout

import numpy as np
import pytest
import torch

from repro_torch.core import (AccessViolation, Actor, ActorFailed,
                              ActorPool, ActorSystem, ArityMismatchError,
                              DanglingPortError, DeviceRef, DownMessage,
                              ExitMessage, Graph, GraphCycleError, In, InOut,
                              NDRange, Out, Pipeline, PortType,
                              PortTypeMismatchError, SignatureMismatch,
                              compose, dim_vec, fuse, kernel, live_ref_count,
                              memory_stats, reset_transfer_stats,
                              transfer_count, tree_release, tree_unwrap,
                              tree_wrap)
from repro_torch.core.memref import registry
from repro_torch.kernels import ops

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


def put(x, access="rw"):
    return DeviceRef.put(x, device=CPU, access=access)


# ----------------------------------------------------------------------------
# actors (paper §2.1)
# ----------------------------------------------------------------------------
def test_spawn_function_actor_and_request(system):
    assert system.spawn(lambda x, y: x + y).ask(2, 3) == 5


def test_messages_processed_in_order(system):
    seen, done = [], threading.Event()

    def behave(i):
        seen.append(i)
        if i == 99:
            done.set()

    ref = system.spawn(behave)
    for i in range(100):
        ref.send(i)
    assert done.wait(10)
    assert seen == list(range(100))


def test_failure_sets_exception_and_kills_actor(system):
    def bad(x):
        raise ValueError("boom")

    ref = system.spawn(bad)
    with pytest.raises(ValueError):
        ref.ask(1)
    assert not ref.is_alive()
    with pytest.raises(ActorFailed):
        ref.ask(2)


def test_promise_delegation(system):
    inner = system.spawn(lambda x: x * 10)
    outer = system.spawn(lambda x: inner.request(x + 1))
    assert outer.ask(4) == 50


@pytest.mark.parametrize("how", ["monitor", "link"])
def test_dying_actor_notifies_exactly_once(system, how):
    """A monitor gets exactly one DownMessage, a trapping link exactly one
    ExitMessage — also when registered while the target terminates."""
    for _ in range(20):
        box, got = [], threading.Event()

        class Watcher(Actor):
            def __init__(self):
                super().__init__()
                self.trap_exit = True

            def receive(self, msg):
                box.append(msg)
                got.set()

        watcher = system.spawn(Watcher())
        target = system.spawn(lambda x: x)
        t = threading.Thread(target=target.exit, args=("bye",))
        t.start()
        if how == "monitor":
            system.monitor(watcher, target)
        else:
            system.link(watcher, target)
        t.join()
        assert got.wait(10)
        time.sleep(0.01)
        assert len(box) == 1
        kind = DownMessage if how == "monitor" else ExitMessage
        assert isinstance(box[0], kind) and box[0].actor_id == target.actor_id


def test_link_kills_non_trapping_actor(system):
    victim = system.spawn(lambda: 1 / 0)
    other = system.spawn(lambda x: x)
    system.link(other, victim)
    victim.send()
    deadline = time.monotonic() + 10
    while other.is_alive() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not other.is_alive()


def test_ask_timeout_names_actor():
    s = ActorSystem(max_workers=2, default_ask_timeout=0.1, device="cpu")
    try:
        sleeper = s.spawn(lambda: time.sleep(2))
        with pytest.raises(FuturesTimeout, match=f"#{sleeper.actor_id}"):
            sleeper.ask()
    finally:
        s.shutdown()


def test_shutdown_terminates_all():
    s = ActorSystem(max_workers=2, device="cpu")
    refs = [s.spawn(lambda x: x) for _ in range(5)]
    s.shutdown()
    assert all(not r.is_alive() for r in refs)


# ----------------------------------------------------------------------------
# DeviceRef data plane (paper §3.5)
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("access,op,exc", [
    ("r", lambda r: r.donate(), AccessViolation),
    ("w", lambda r: r.array, AccessViolation),
    ("w", lambda r: r.to_value(), AccessViolation),
    ("w", lambda r: r.spill(), AccessViolation),
    ("r", lambda r: r.restrict("rw"), AccessViolation),
    ("rw", lambda r: r.restrict("x"), ValueError),
])
def test_access_rights_are_enforced(access, op, exc):
    ref = put(np.ones(4, np.float32), access=access)
    with pytest.raises(exc):
        op(ref)
    ref.release()


@pytest.mark.parametrize("op", [lambda r: r.array, lambda r: r.donate(),
                                lambda r: r.spill(), lambda r: r.to_value()])
def test_use_after_donation_raises(op):
    ref = put(np.zeros(4, np.float32))
    arr = ref.donate()
    assert isinstance(arr, torch.Tensor) and arr.shape == (4,)
    with pytest.raises(RuntimeError, match="donat"):
        op(ref)
    ref.release()       # release after donation is a no-op


def test_donate_retires_accounting():
    base = registry.live_bytes()
    ref = put(np.ones(8, np.float32))
    assert registry.live_bytes() == base + 32
    ref.donate()
    assert registry.live_bytes() == base


def test_spill_roundtrip_through_pickle(ref_baseline):
    data = np.arange(12, dtype=np.float32).reshape(3, 4)
    ref = put(data)
    with pytest.raises(TypeError):
        pickle.dumps(ref)
    base = registry.live_bytes()
    ref.spill()
    assert ref.is_spilled and registry.live_bytes() == base - 48
    with pytest.raises(RuntimeError, match="spill"):
        _ = ref.array
    before = transfer_count()
    np.testing.assert_array_equal(ref.to_value(), data)   # host copy, no transfer
    assert transfer_count() == before
    clone = pickle.loads(pickle.dumps(ref))
    assert clone.is_spilled and clone.shape == (3, 4)
    ref.unspill()
    assert registry.live_bytes() == base
    np.testing.assert_array_equal(ref.to_value(), data)
    clone.unspill(CPU)
    np.testing.assert_array_equal(clone.to_value(), data)
    ref.release()
    clone.release()
    assert_refs_settle(ref_baseline)


def test_release_is_idempotent_and_terminal(ref_baseline):
    ref = put(np.ones(4, np.float32))
    ref.release()
    ref.release()
    with pytest.raises(RuntimeError):
        _ = ref.array
    assert_refs_settle(ref_baseline)


def test_registry_watermark_and_device_stats(mngr):
    dev = mngr.find_device()
    assert dev.torch_device == CPU and dev.name == "cpu:0"
    base = dev.live_bytes()
    refs = [put(np.zeros(64, np.float32)) for _ in range(4)]
    assert dev.live_bytes() == base + 4 * 256
    assert dev.peak_bytes() >= dev.live_bytes()
    assert mngr.memory_stats()[dev.name]["live_bytes"] == dev.live_bytes()
    for r in refs:
        r.release()
    assert dev.live_bytes() == base


def test_repr_and_uint32_refs():
    ref = put(np.arange(4, dtype=np.uint32))
    assert repr(ref) == "DeviceRef<uint32>[4][rw, live/ready, 16B @ cpu]"
    view = ref.restrict("r")
    assert view.to_value().dtype == np.uint32
    ref.spill()
    assert repr(ref) == "DeviceRef<uint32>[4][rw, spilled, 16B @ host]"
    ref.release()
    view.release()
    assert repr(ref) == "DeviceRef<uint32>[4][rw, released]"


def test_tree_wrap_unwrap_release(ref_baseline):
    tree = {"k": np.ones((2, 3), np.float32), "v": [np.arange(4), None]}
    created = []
    refs = tree_wrap(tree, device=CPU, created=created)
    assert len(created) == 2 and refs["v"][1] is None
    arrays = tree_unwrap(refs)
    assert isinstance(arrays["k"], torch.Tensor) and arrays["k"].shape == (2, 3)
    assert tree_release(refs) == 2
    assert_refs_settle(ref_baseline)


# ----------------------------------------------------------------------------
# kernel facade (paper §3.2–3.6)
# ----------------------------------------------------------------------------
def test_m_mult_value_semantics(mngr):
    n = 32
    w = mngr.spawn(kernel(In(torch.float32), In(torch.float32),
                          Out(torch.float32, shape=(n, n)),
                          nd_range=NDRange(dim_vec(n, n)),
                          name="m_mult")(lambda a, b: ops.matmul(a, b)))
    rng = np.random.default_rng(0)
    a, b = rng.random((n, n), np.float32), rng.random((n, n), np.float32)
    before = memory_stats()["readbacks"]
    r = w.ask(a, b)
    assert isinstance(r, np.ndarray)
    np.testing.assert_allclose(r, a @ b, rtol=1e-5)
    assert memory_stats()["readbacks"] == before + 1


def test_out_ref_is_device_resident_and_not_picklable(mngr):
    w = mngr.spawn(kernel(In(torch.float32), Out(torch.float32, as_ref=True),
                          name="scale")(lambda x: x * 3.0))
    r = w.ask(np.ones(8, np.float32))
    assert isinstance(r, DeviceRef) and r.device == CPU
    with pytest.raises(TypeError):
        pickle.dumps(r)
    np.testing.assert_allclose(r.to_value(), 3.0)
    r.release()


def test_inout_updates_in_place_and_donates_the_ref(mngr):
    producer = mngr.spawn(kernel(In(torch.float32),
                                 Out(torch.float32, as_ref=True),
                                 name="p")(lambda x: x + 1.0))
    updater = mngr.spawn(kernel(InOut(torch.float32, as_ref=True),
                                name="u")(lambda x: x.mul_(2.0)))
    ref = producer.ask(np.zeros(4, np.float32))
    buf = ref.array
    out = updater.ask(ref)
    np.testing.assert_allclose(out.to_value(), 2.0)
    assert out.array.data_ptr() == buf.data_ptr()     # updated in place
    with pytest.raises(RuntimeError, match="donat"):
        _ = ref.array
    out.release()


def test_inout_without_donation_leaves_caller_buffer(mngr):
    updater = mngr.spawn(kernel(InOut(torch.float32, as_ref=True),
                                donate=False, name="u2")(lambda x: x.add_(1.0)))
    ref = put(np.zeros(4, np.float32))
    out = updater.ask(ref)
    np.testing.assert_allclose(out.to_value(), 1.0)
    np.testing.assert_allclose(ref.to_value(), 0.0)
    out.release()
    ref.release()


def test_inout_host_value_is_not_aliased(mngr):
    updater = mngr.spawn(kernel(InOut(torch.float32), name="u3")(
        lambda x: x.add_(1.0)))
    host = np.zeros(4, np.float32)
    np.testing.assert_allclose(updater.ask(host), 1.0)
    np.testing.assert_allclose(host, 0.0)


def test_inout_rejects_read_only_view(mngr):
    updater = mngr.spawn(kernel(InOut(torch.float32, as_ref=True),
                                name="u4")(lambda x: x * 2.0))
    full = put(np.ones(4, np.float32))
    ro = full.restrict("r")
    with pytest.raises(AccessViolation):
        updater.ask(ro)
    full.release()
    ro.release()


@pytest.mark.parametrize("payload", [
    (np.zeros(4, np.int32),),                               # wrong dtype
    (np.zeros(4, np.float32), np.zeros(4, np.float32)),     # wrong arity
])
def test_signature_mismatch_raises(mngr, payload):
    w = mngr.spawn(kernel(In(torch.float32), Out(torch.float32),
                          name="id")(lambda x: x))
    with pytest.raises(SignatureMismatch):
        w.ask(*payload)


def test_untyped_payload_adopts_spec_dtype(mngr):
    w = mngr.spawn(kernel(In(torch.uint32), Out(torch.uint32),
                          name="idu")(lambda x: x))
    out = w.ask([1, 2, 3])
    assert out.dtype == np.uint32 and out.tolist() == [1, 2, 3]


def test_pre_post_processing(mngr):
    n = 8
    w = mngr.spawn(kernel(In(torch.float32), In(torch.float32),
                          Out(torch.float32, shape=(n, n)), name="mm_pp",
                          preprocess=lambda pair: tuple(
                              m.astype(np.float32) for m in pair),
                          postprocess=lambda r: {"matrix": r})(
                              lambda a, b: ops.matmul(a, b)))
    out = w.ask((np.eye(n), np.eye(n)))
    np.testing.assert_allclose(out["matrix"], np.eye(n))


def test_v1_positional_spawn(mngr):
    with pytest.warns(PendingDeprecationWarning):
        w = mngr.spawn(lambda x: x + 1.0, "inc", NDRange(dim_vec(4)),
                       In(torch.float32), Out(torch.float32))
    np.testing.assert_allclose(w.ask(np.zeros(4, np.float32)), 1.0)


# ----------------------------------------------------------------------------
# @kernel + Pipeline (api.py)
# ----------------------------------------------------------------------------
@kernel(In(torch.float32), Out(torch.float32), nd_range=NDRange(dim_vec(N)),
        name="p1")
def p1(x):
    return x + 1.0


@kernel(In(torch.float32), Out(torch.float32), nd_range=NDRange(dim_vec(N)),
        name="p2")
def p2(x):
    return x * 2.0


@kernel(In(torch.float32), Out(torch.float32), nd_range=NDRange(dim_vec(N)),
        name="p3")
def p3(x):
    return x - 3.0


def _expected(x):
    return (x + 1.0) * 2.0 - 3.0


def test_kernel_decorator_captures_signature():
    assert p1.name == "p1" and p1.nd_range.global_dims == (N,)
    assert len(p1.signature.input_specs) == 1
    assert p1.signature.input_specs[0].torch_dtype == torch.float32
    resized = p1.with_options(nd_range=NDRange(dim_vec(2 * N)))
    assert resized.nd_range.global_dims == (2 * N,) and p1.nd_range.global_dims == (N,)
    with pytest.raises(TypeError):
        p1.with_options(bogus=1)


def test_spawn_rejects_unknown_options(mngr):
    with pytest.raises(TypeError):
        mngr.spawn(p1, bogus=True)


@pytest.mark.parametrize("mode", ["staged", "fused", "auto"])
def test_pipeline_modes_agree(system, ref_baseline, mode):
    pipe = Pipeline(system, mode=mode).stage(p1).stage(p2).stage(p3).build()
    x = np.arange(N, dtype=np.float32)
    reset_transfer_stats()
    np.testing.assert_allclose(pipe.ask(x), _expected(x))
    assert transfer_count() == 0
    assert memory_stats()["readbacks"] == 1
    assert_refs_settle(ref_baseline)


def test_pipeline_auto_fuses_kernels_on_one_device(system):
    assert Pipeline(system).stage(p1).stage(p2).resolved_mode() == "fused"
    opaque = system.spawn(lambda x: x)
    assert Pipeline(system).stage(p1).stage(opaque).resolved_mode() == "staged"


def test_pipeline_with_adapter_and_existing_actor(system, mngr):
    a1 = mngr.spawn(p1)
    pipe = (Pipeline(system, mode="staged").stage(a1)
            .stage(lambda x: x * 2.0).stage(p3).build())
    x = np.arange(N, dtype=np.float32)
    np.testing.assert_allclose(pipe.ask(x), _expected(x))


def test_pipeline_empty_or_bad_stage_raises(system):
    with pytest.raises(ValueError):
        Pipeline(system).build()
    with pytest.raises(TypeError):
        Pipeline(system).stage(42)


def test_v1_compose_and_fuse_shims(system, mngr):
    refs = [mngr.spawn(k) for k in (p1, p2, p3)]
    x = np.arange(N, dtype=np.float32)
    with pytest.warns(DeprecationWarning):
        staged = compose(system, *refs)
    with pytest.warns(DeprecationWarning):
        fused = fuse(system, *refs)
    np.testing.assert_allclose(staged.ask(x), _expected(x))
    np.testing.assert_allclose(fused.ask(x), _expected(x))
    np.testing.assert_allclose((refs[2] * refs[1] * refs[0]).ask(x), _expected(x))


@pytest.mark.parametrize("policy", ["round_robin", "least_loaded"])
def test_pool_routes_to_every_worker(system, mngr, policy):
    pool = mngr.spawn_pool(p1, 3, policy=policy)
    assert isinstance(pool, ActorPool) and len(pool.workers) == 3
    x = np.zeros(N, np.float32)
    futs = [pool.submit(x) for _ in range(9)]
    for f in futs:
        np.testing.assert_allclose(f.result(10), 1.0)
    if policy == "round_robin":
        assert {f.worker.actor_id for f in futs} == {w.actor_id for w in pool.workers}


# ----------------------------------------------------------------------------
# typed dataflow graphs (graph.py)
# ----------------------------------------------------------------------------
@kernel(In(torch.float32), In(torch.float32), Out(torch.float32),
        nd_range=NDRange(dim_vec(N)), name="add2")
def add2(a, b):
    return a + b


def _diamond(system, sink=add2, name="diamond"):
    g = Graph(system, name=name)
    x = g.source("x", torch.float32, shape=(N,))
    l, r = g.broadcast(x, 2)
    j1, j2 = g.zip_join(g.apply(p2, l), g.apply(p3, r))
    g.output(g.apply(sink, j1, j2))
    return g


@pytest.mark.parametrize("as_ref", [False, True])
def test_diamond_keeps_interior_edges_on_device(system, ref_baseline, as_ref):
    sink = add2.with_options(specs=(In(torch.float32), In(torch.float32),
                                    Out(torch.float32, as_ref=as_ref)))
    g = _diamond(system, sink, name=f"diamond_{as_ref}")
    assert len(g.nodes) == 6
    built = g.build()
    x = np.arange(N, dtype=np.float32)
    reset_transfer_stats()
    out = built.ask(x)
    assert transfer_count() == 0
    if as_ref:
        assert isinstance(out, DeviceRef)
        assert memory_stats()["readbacks"] == 0
        out = out.to_value()
    else:
        assert memory_stats()["readbacks"] == 1
    np.testing.assert_allclose(out, x * 2 + x - 3)
    assert_refs_settle(ref_baseline + (1 if as_ref else 0))


def test_graph_fusion_pass_collapses_linear_kernels(system):
    g = Graph(system, name="chain")
    x = g.source("x", torch.float32, shape=(N,))
    g.output(g.apply(p3, g.apply(p2, g.apply(p1, x))))
    built = g.build(fuse=True)
    assert built.plan.fused_regions == [["chain/p1", "chain/p2", "chain/p3"]]
    x_in = np.arange(N, dtype=np.float32)
    np.testing.assert_allclose(built.ask(x_in), _expected(x_in))


def test_graph_ports_are_typed_by_meta_evaluation(system):
    """Port types come from evaluating the kernel on meta tensors — also
    through a hand-written kernel's custom op."""
    mm = kernel(In(torch.float32), In(torch.float32), Out(torch.float32),
                name="mm")(lambda a, b: ops.matmul(a, b))
    g = Graph(system, name="typed")
    a = g.source("a", torch.float32, shape=(3, 4))
    b = g.source("b", torch.float32, shape=(4, 5))
    out = g.apply(mm, a, b)
    g.output(out)
    g.validate()
    assert out.type == PortType.of(torch.float32, (3, 5))


@pytest.mark.parametrize("build_bad,exc,needle", [
    ("cycle", GraphCycleError, "cyc/"),
    ("unbound", DanglingPortError, "slot 0"),
    ("unconsumed", DanglingPortError, "no consumer"),
    ("arity", ArityMismatchError, "declares 2 inputs"),
    ("dtype", PortTypeMismatchError, "expects dtype float32"),
    ("kernel_dtype", PortTypeMismatchError, "computes float64"),
])
def test_graph_validation_errors_name_the_node(system, build_bad, exc, needle):
    g = Graph(system, name="cyc" if build_bad == "cycle" else "bad")
    if build_bad == "cycle":
        a, b = g.node(p1), g.node(p2)
        g.bind(a, 0, b.out())
        g.bind(b, 0, a.out())
        g.output(b.out())
    elif build_bad == "unbound":
        g.output(g.node(p1).out())
    elif build_bad == "unconsumed":
        x = g.source("x", torch.float32, shape=(N,))
        g.apply(p1, x)
        g.output(g.apply(p2, x))
    elif build_bad == "arity":
        x = g.source("x", torch.float32, shape=(N,))
        g.output(g.apply(add2, x))
    elif build_bad == "dtype":
        x = g.source("x", torch.int32, shape=(N,))
        g.output(g.apply(p1, x))
    else:
        wrong = kernel(In(torch.float32), Out(torch.float32),
                       name="wrong")(lambda x: x.double())
        x = g.source("x", torch.float32, shape=(N,))
        g.output(g.apply(wrong, x))
    with pytest.raises(exc, match=needle):
        g.build()


@pytest.mark.parametrize("fill,want", [(1.0, lambda x: x * 2.0),
                                       (100.0, lambda x: x - 3.0)])
def test_select_merge_routes_by_predicate(system, fill, want):
    def pred(v):
        arr = v.to_value() if isinstance(v, DeviceRef) else np.asarray(v)
        return 0 if float(arr[0]) < 50 else 1

    g = Graph(system, name=f"route_{int(fill)}")
    x = g.source("x", torch.float32, shape=(N,))
    t, f = g.select(x, pred)
    g.output(g.merge(g.apply(p2, t), g.apply(p3, f)))
    x_in = np.full(N, fill, np.float32)
    np.testing.assert_allclose(g.build().ask(x_in), want(x_in))


def test_fused_chain_dispatches_inline_on_ask(system):
    pipe = Pipeline(system, mode="fused", name="inline").stages(
        [p1, p2, p3]).build()
    x = np.arange(N, dtype=np.float32)
    for _ in range(3):
        np.testing.assert_allclose(pipe.ask(x), _expected(x))
    assert pipe.dispatch_stats == {"inline": 3, "mailbox": 0}
    np.testing.assert_allclose(pipe.request(x).result(10), _expected(x))
    assert pipe.dispatch_stats["mailbox"] == 1
