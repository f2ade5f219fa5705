"""Three-process serve-mesh demo: a MeshRouter on the driver sharding
requests across EngineReplica actors on worker nodes, surviving a
worker SIGKILL mid-traffic — the port of the JAX package's
``repro/launch/serve_mesh.py``.

    python -m repro_torch.launch.serve_mesh --workers 2 --rps 40 --duration 6
    python -m repro_torch.launch.serve_mesh --device cpu

The driver listens, starts generic worker processes by
``multiprocessing``'s ``spawn`` method
(:func:`repro_torch.launch.node.run_worker` — the same entry every
distributed demo uses; behaviors ship at spawn time), ``spawn_remote``\\ s
one engine replica per worker, and drives an offered load. Once a
quarter of the requests have completed, a worker is SIGKILLed the
moment the router's state shows its replica holding a request in flight
(the worker is stopped first, so the request cannot complete between
the read and the kill): the router's monitor fires on NodeDown, the
requests in flight on the dead replica replay on the survivors, and the
demo asserts **zero lost and zero duplicated requests** — every
submitted request resolves exactly once with the tokens the model
predicts. The returned summary records achieved RPS and p99 latency
before / during / after the failure window.

Every process binds ``cuda:0`` (each worker its own CUDA context) unless
``--device`` / ``device=`` asks for another device or the CPU; without a
card the driver raises :class:`LookupError`.

Everything here is module-level so both sides of the spawn can import it
(a worker needs :func:`toy_engine` or :func:`model_engine` importable to
build the shipped :class:`~repro_torch.serve.mesh.ReplicaSpec`).
"""
from __future__ import annotations

import os
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch

__all__ = ["toy_engine", "model_engine", "expected_tokens", "run_demo",
           "main"]


# ----------------------------------------------------------------------------
# replica factories (module-level: shipped to workers inside a ReplicaSpec)
# ----------------------------------------------------------------------------
def toy_engine(system, *, service_delay_s: float = 0.01, n_workers: int = 1,
               max_batch: int = 8, max_wait_ms: float = 2.0):
    """Engine factory for :class:`~repro_torch.serve.mesh.ReplicaSpec`:
    the counter toy model (cache row ``[seed, step]``, token ``seed*1000
    + step`` — every request's output is predictable, so exactly-once is
    checkable from results alone) on the system's device, slowed by
    ``service_delay_s`` per decode step to simulate real model cost."""
    from ..serve import ServeEngine

    dev = system.opencl_manager().find_device().torch_device

    def step(cache, tokens):
        if service_delay_s:
            time.sleep(service_delay_s)
        next_tok = (cache[:, 0] * 1000 + cache[:, 1]).to(torch.int32)
        return next_tok, cache + torch.tensor([0, 1], dtype=cache.dtype,
                                              device=cache.device)

    def init(prompt):
        return torch.tensor([int(prompt), 0], dtype=torch.int32,
                            device=dev), 0

    return ServeEngine(system, step, init, n_workers=n_workers,
                       max_batch=max_batch, max_wait_ms=max_wait_ms)


def model_engine(system, *, arch: str = "qwen3-1.7b",
                 dtype: str = "bfloat16", seed: int = 0, max_batch: int = 8,
                 steps: int = 16):
    """Engine factory for :class:`~repro_torch.serve.mesh.ReplicaSpec`
    over a real model: ``arch``'s published config in ``dtype``, random
    weights from
    ``Model.init(seed)`` on the system's device — a seeded generator on
    that device, so every process builds the same weights — served
    greedily as ``launch.serve`` serves it (:func:`~repro_torch.launch.
    serve.engine_fns`; a request's prompt is its first token; batches are
    gang-scheduled, since the cache carries a batch-uniform position).

    Each request's cache holds ``steps + 1`` positions: a request may ask
    for at most ``steps`` tokens. With ``max_batch=1`` every request is
    decoded alone, exactly as one engine with ``max_batch=1`` decodes it,
    so a replayed request gives the same tokens (in f32 with TF32 off,
    PyTorch's default in a fresh process). Every keyword is a name or a
    number, so the spec pickles."""
    import dataclasses

    from .. import configs
    from ..models import Model
    from ..serve import ServeEngine
    from .serve import check_cache_capacity, engine_fns

    dev = system.opencl_manager().find_device().torch_device
    cfg = configs.get_config(arch)
    cfg = dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)
    model = Model(cfg, attn_impl="kernel", device=dev)
    params = model.init(seed)
    capacity = check_cache_capacity(steps, steps + 1)
    step_fn, combine, split = engine_fns(model, params, capacity)

    def init_fn(prompt):
        return model.init_cache(1, capacity), int(prompt)

    return ServeEngine(system, step_fn, init_fn, n_workers=1,
                       max_batch=max_batch, allow_join=False,
                       combine=combine, split=split)


def expected_tokens(seed: int, n: int) -> List[int]:
    return [seed * 1000 + i for i in range(n)]


# ----------------------------------------------------------------------------
# driver
# ----------------------------------------------------------------------------
def _window_metrics(records, done_times, start: float, end: float,
                   label: str) -> Dict[str, Any]:
    """Achieved RPS (completions landing in the window) and p99 latency
    (requests *submitted* in the window) for one wall-clock slice."""
    done_in = [t for t in done_times.values() if start <= t < end]
    lats = sorted(done_times[i] - sub for i, (sub, _) in enumerate(records)
                  if start <= sub < end and i in done_times)
    span = max(end - start, 1e-9)
    return {
        "window": label,
        "start_s": start,
        "end_s": end,
        "completed": len(done_in),
        "achieved_rps": len(done_in) / span,
        "p99_ms": (lats[min(len(lats) - 1,
                            int(round(0.99 * (len(lats) - 1))))] * 1e3
                   if lats else 0.0),
    }


def _kill_when_busy(router, procs: Dict[str, Any],
                    armed: Callable[[], bool], stop: threading.Event,
                    killed: Dict[str, Any], t0: float) -> None:
    """Once ``armed()``, SIGKILL the worker process (``procs``: replica
    key → process) of the first replica the router shows holding a
    request in flight. The worker is stopped (SIGSTOP) and the state read
    again after any reply already on the wire has landed, so the request
    cannot complete between the read and the kill; a worker found idle
    by then is continued (SIGCONT)."""
    def inflight(key):
        return router.stats()["replicas"][key]["inflight"]

    while not stop.wait(0.002):
        if not armed():
            continue
        key = next((k for k in procs if inflight(k) >= 1), None)
        if key is None:
            continue
        os.kill(procs[key].pid, signal.SIGSTOP)
        stop.wait(0.05)
        if inflight(key) >= 1:
            procs[key].kill()
            killed.update(t=time.monotonic() - t0, replica=key)
            return
        os.kill(procs[key].pid, signal.SIGCONT)


def run_demo(workers: int = 2, *, rps: float = 40.0, duration_s: float = 6.0,
             recover_window_s: float = 1.5, max_new_tokens: int = 4, spec=None,
             expected: Callable[[int, int], List[int]] = expected_tokens,
             kill_one: bool = True,
             timeout: float = 120.0, device=None) -> dict:
    """Run the 1-driver + ``workers``-worker mesh; returns a summary dict
    (also asserts the acceptance invariants — an AssertionError here is a
    real regression).

    ``round(rps × duration_s)`` requests, request ``i`` with prompt ``i``,
    are submitted at ``rps``; each must give ``expected(i,
    max_new_tokens)``. ``spec`` is each worker's replica (default: the
    toy model at 10 ms a step). A worker is killed once a quarter of the
    requests have completed and its replica holds one in flight; the
    achieved RPS after the failure window must then reach 0.8 of the RPS
    before it."""
    import multiprocessing as mp

    from ..core import ActorSystem
    from ..net import NodeRuntime
    from ..serve import MeshRouter, ReplicaSpec
    from .node import run_worker

    n_requests = max(1, round(rps * duration_s))
    if spec is None:
        spec = ReplicaSpec(toy_engine, service_delay_s=0.01)
    summary: dict = {"workers": workers, "offered_rps": rps,
                     "requests": n_requests, "kill_one": kill_one}
    system = ActorSystem("mesh-driver", device=device)
    try:
        node = NodeRuntime(system, name="driver", listen=("127.0.0.1", 0))
    except BaseException:
        system.shutdown()
        raise
    dev = str(node.unspill_device)
    summary["device"] = dev
    ctx = mp.get_context("spawn")
    children: Dict[str, Any] = {}
    stop_killer = threading.Event()
    killer: Optional[threading.Thread] = None
    try:
        for i in range(workers):
            name = f"worker{i}"
            p = ctx.Process(target=run_worker, args=(node.address, name),
                            kwargs={"device": dev}, daemon=True)
            p.start()
            children[name] = p
        deadline = time.monotonic() + timeout
        for name, p in children.items():
            while not node.wait_for_peer(name, 1.0):
                if not p.is_alive() or time.monotonic() > deadline:
                    raise TimeoutError(f"{name} never connected (exit "
                                       f"code {p.exitcode})")
        summary["worker_devices"] = {
            name: node.peer_stats(name, timeout)["device"]
            for name in children}

        router = MeshRouter(system, node, spec=spec, slo_budget_s=5.0,
                            min_replicas=workers, max_replicas=workers,
                            control_interval=0.1, max_attempts=5)
        reps = {name: router.spawn_replica(name) for name in children}
        router.start()
        # first touch builds each replica's engine (lazy on_start), and a
        # short warm-up pays every replica's first-step cost before the
        # clock starts — the pre-failure window should measure steady
        # state, not cold start
        for rep in reps.values():
            rep.ref.ask("ping", timeout=timeout)
        n_warm = 4 * workers
        for f in [router.submit(0, max_new_tokens=2)
                  for _ in range(n_warm)]:
            f.result(timeout)

        t0 = time.monotonic()
        records: List[tuple] = []        # (submit_rel_s, future)
        done_times: Dict[int, float] = {}  # index -> completion_rel_s
        killed: Dict[str, float] = {}
        if kill_one:
            procs = {reps[name].key: p for name, p in children.items()}
            killer = threading.Thread(
                target=_kill_when_busy, name="mesh-killer", daemon=True,
                args=(router, procs,
                      lambda: len(done_times) >= n_requests // 4,
                      stop_killer,
                      killed, t0))
            killer.start()

        all_done = threading.Event()

        def on_done(i, fut):
            done_times[i] = time.monotonic() - t0
            if len(done_times) == n_requests:
                all_done.set()

        for i in range(n_requests):
            time.sleep(max(0.0, t0 + i / rps - time.monotonic()))
            fut = router.submit(i, max_new_tokens=max_new_tokens)
            records.append((time.monotonic() - t0, fut))
            fut.add_done_callback(lambda f, i=i: on_done(i, f))

        # every request resolves — lost requests would hang/raise here,
        # duplicates are impossible by construction (a future resolves
        # once; first-wins)
        for i, (_, fut) in enumerate(records):
            res = fut.result(timeout)
            assert [int(t) for t in res.tokens] == \
                expected(i, max_new_tokens), \
                f"request {i} got wrong tokens {res.tokens}"
        # a future's callbacks run after its waiters wake
        assert all_done.wait(timeout), "a completion went missing"
        stop_killer.set()
        if killer is not None:
            killer.join(timeout)

        s = router.stats()
        summary["submitted"] = s["submitted"] - n_warm
        summary["completed"] = s["completed"] - n_warm
        summary["replayed"] = s["replayed"]
        summary["replicas_lost"] = s["replicas_lost"]
        summary["lost"] = s["submitted"] - s["completed"]
        assert s["completed"] == len(records) + n_warm, s
        assert s["failed"] == 0 and s["shed"] == 0, s

        end = max(done_times.values())
        if kill_one:
            assert "t" in killed, \
                f"no worker held a request in flight once armed: {s}"
            assert s["replicas_lost"] == 1, s
            assert s["replayed"] >= 1, s
            kill_at = killed["t"]
            summary["killed_replica"] = killed["replica"]
        else:
            kill_at = end / 2
        summary["kill_at_s"] = kill_at
        pre = _window_metrics(records, done_times, 0.0, kill_at, "pre")
        during = _window_metrics(records, done_times, kill_at,
                                kill_at + recover_window_s, "during")
        post = _window_metrics(records, done_times,
                              kill_at + recover_window_s,
                              max(duration_s, end + 1e-9), "post")
        summary["windows"] = [pre, during, post]
        if kill_one:
            assert post["achieved_rps"] >= 0.8 * pre["achieved_rps"], \
                (f"throughput did not recover: pre {pre['achieved_rps']:.1f} "
                 f"rps, post {post['achieved_rps']:.1f} rps")
        router.shutdown()
        return summary
    finally:
        stop_killer.set()
        node.shutdown()
        system.shutdown()
        for p in children.values():
            if p.is_alive():
                p.kill()
            p.join(timeout=30)


def main(argv=None) -> None:
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--rps", type=float, default=40.0)
    p.add_argument("--duration", type=float, default=6.0)
    p.add_argument("--no-kill", action="store_true",
                   help="skip the mid-run worker SIGKILL")
    p.add_argument("--device", default=None,
                   help="device of every node (default: cuda:0; 'cpu' "
                        "runs on the CPU)")
    args = p.parse_args(argv)
    out = run_demo(args.workers, rps=args.rps, duration_s=args.duration,
                   kill_one=not args.no_kill, device=args.device)
    print(json.dumps(out, indent=2, default=str))


if __name__ == "__main__":
    main()
