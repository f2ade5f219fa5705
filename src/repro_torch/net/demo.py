"""Two-process demo: a 3-stage pipeline whose middle stage lives on
another node, plus node-death supervision and exactly-once chunk
re-issue — the port of the JAX package's ``repro/net/demo.py``.

    python -m repro_torch.net.demo [--device cpu]

This module is importable from both sides of a ``multiprocessing`` spawn
(behaviors and the child entry point must be module-level for pickling).
The child is started by the ``spawn`` method, never ``fork``: the driver
may have initialised CUDA. Both processes bind ``device`` (``cuda:0``
unless the caller asks for the CPU).

What it demonstrates:

1. **Network transparency** — the middle stage is a
   :class:`~repro_torch.net.RemoteActorRef` used exactly like a local ref.
2. **Spill-based wire format** — the stage boundary is one (optionally
   int8-compressed) spill/unspill pair per wire hop, asserted via
   ``memory_stats()`` counters **on both sides** (each process has its own
   ref registry).
3. **Cross-node supervision + exactly-once** — SIGKILLing the worker
   process mid-run delivers a :class:`~repro_torch.core.errors.DownMessage`
   to local monitors, and the chunks in flight on the dead node are
   re-issued on the surviving local worker with every result counted
   exactly once.
"""
from __future__ import annotations

import threading
from typing import Tuple

__all__ = ["main", "run_child", "stage_square", "chunk_work"]

#: per-chunk compute time for the kill-mid-run phase — long enough that
#: chunks are in flight on the remote node when it is killed
CHUNK_DELAY_S = 0.15

#: never set — waited on with a timeout to simulate per-chunk compute.
#: Behaviors must not time.sleep (blocking-call-in-behavior): an Event
#: wait is interruptible in principle, a sleep never is.
_simulated_work = threading.Event()


def _simulate_compute() -> None:
    _simulated_work.wait(CHUNK_DELAY_S)


# ----------------------------------------------------------------------------
# behaviors (module-level: shipped to / run on the worker node)
# ----------------------------------------------------------------------------
def stage_square(ref):
    """Middle pipeline stage (remote): ref in → ref out, on-device."""
    from repro_torch.core import DeviceRef
    x = ref.array
    return DeviceRef(x * x)


def chunk_work(i: int):
    """A deliberately slow chunk for the kill-mid-run phase."""
    _simulate_compute()
    return ("remote", i)


def run_child(addr: Tuple[str, int], name: str, compress: bool,
              device=None) -> None:
    """Worker-process entry: join the cluster on ``device``, publish the
    stage and the chunk worker, serve until the driver goes away (or is
    killed)."""
    from repro_torch.core import ActorSystem
    from repro_torch.net import NodeRuntime

    system = ActorSystem(name, device=device)
    node = NodeRuntime(system, name=name, compress=compress)
    try:
        # publish BEFORE connecting: the driver's wait_for_peer returns as
        # soon as the hello handshake lands, so a lookup RPC can arrive
        # immediately — publishing after connect loses that race
        node.publish("stage-square", system.spawn(stage_square))
        node.publish("chunk-worker", system.spawn(chunk_work))
        node.connect(tuple(addr))
        node.join()
    finally:
        node.shutdown()
        system.shutdown()


# ----------------------------------------------------------------------------
# driver
# ----------------------------------------------------------------------------
def main(n: int = 4096, chunks: int = 12, *, compress: bool = True,
         kill_mid_run: bool = True, timeout: float = 120.0,
         device=None) -> dict:
    """Run the demo on ``device`` (``cuda:0`` by default; ``"cpu"`` when
    asked); returns a summary dict (also asserts the acceptance
    invariants — an AssertionError here is a real regression)."""
    import multiprocessing as mp

    import numpy as np
    import torch

    from repro_torch.core import (ActorPool, ActorSystem, ChunkScheduler,
                                  DeviceRef, DownMessage, memory_stats,
                                  reset_transfer_stats)
    from repro_torch.net import NodeRuntime

    summary: dict = {"compress": compress}
    system = ActorSystem("driver", device=device)
    dev = system.opencl_manager().find_device().torch_device
    node = NodeRuntime(system, name="driver", listen=("127.0.0.1", 0),
                       compress=compress)
    summary["device"] = str(dev)
    ctx = mp.get_context("spawn")
    child = ctx.Process(target=run_child,
                        args=(node.address, "worker", compress, str(dev)),
                        daemon=True)
    child.start()
    try:
        if not node.wait_for_peer("worker", timeout):
            raise TimeoutError("worker process never connected")

        # -- phase 1: 3-stage pipeline, stage 2 across the wire ------------
        prepare = system.spawn(lambda x: DeviceRef(
            torch.as_tensor(x, dtype=torch.float32, device=dev) + 1.0))
        remote_square = node.remote_actor("worker", "stage-square", timeout)
        reduce_ = system.spawn(lambda ref: float(ref.to_value().sum()))

        x = np.arange(n, dtype=np.float32)
        reset_transfer_stats()
        ref1 = prepare.ask(x)                    # stage 1 (local, on-device)
        ref2 = remote_square.ask(ref1)           # stage 2 (remote): 2 hops
        total = reduce_.ask(ref2)                # stage 3 (local)
        expect = float(((x + 1.0) ** 2).sum())
        rel = abs(total - expect) / expect
        tol = 2e-2 if compress else 1e-5         # int8 wire is lossy
        assert rel < tol, f"pipeline result off by {rel:.3%}"
        assert ref2.device.type == dev.type, ref2

        driver_stats = memory_stats()
        worker_stats = node.peer_stats("worker", timeout)
        # exactly one spill/unspill pair per wire hop, on each side:
        # driver spills the request (hop 1) and unspills the reply (hop 2);
        # the worker mirrors it. Registries are per-process, so the two
        # snapshots are genuinely independent.
        assert driver_stats["spills"] == 1, driver_stats
        assert driver_stats["unspills"] == 1, driver_stats
        assert worker_stats["spills"] == 1, worker_stats
        assert worker_stats["unspills"] == 1, worker_stats
        summary.update(pipeline_result=total, rel_err=rel,
                       driver_stats=driver_stats, worker_stats=worker_stats)

        if not kill_mid_run:
            return summary

        # -- phase 2: kill the worker node mid-run -------------------------
        remote_worker = node.remote_actor("worker", "chunk-worker", timeout)
        local_worker = system.spawn(
            lambda i: (_simulate_compute(), ("local", i))[1])
        downs: list = []
        got_down = threading.Event()
        watcher = system.spawn(lambda m: (downs.append(m), got_down.set()))
        system.monitor(watcher, remote_worker)

        pool = ActorPool(system, [local_worker, remote_worker])
        sched = ChunkScheduler(pool, max_attempts=4)
        killer = threading.Timer(CHUNK_DELAY_S * 2.5, child.kill)
        killer.start()
        try:
            results = sched.run([(i,) for i in range(chunks)], timeout=timeout)
        finally:
            killer.cancel()
        ids = sorted(i for _, i in results)
        assert ids == list(range(chunks)), f"not exactly-once: {ids}"
        assert got_down.wait(timeout), "no DownMessage after node death"
        assert isinstance(downs[0], DownMessage)
        assert downs[0].actor_id == remote_worker.actor_id
        assert not remote_worker.is_alive()
        summary.update(
            chunks=chunks,
            reissued=sched.stats["failed"],
            sources={src for src, _ in results},
            down=repr(downs[0]),
        )
        return summary
    finally:
        node.shutdown()
        system.shutdown()
        if child.is_alive():
            child.kill()
        child.join(timeout=30)


if __name__ == "__main__":
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="device of both nodes (default: cuda:0)")
    args = p.parse_args()
    out = main(device=args.device)
    print(json.dumps({k: (sorted(v) if isinstance(v, set) else v)
                      for k, v in out.items()}, indent=2, default=str))
