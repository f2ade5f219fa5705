"""Worker-node launcher: join a cluster and serve actors until the
driver goes away — the port of the JAX package's ``repro/launch/node.py``.

    python -m repro_torch.launch.node --connect 127.0.0.1:45123 --name worker0

A bare worker node publishes nothing of its own — the driver populates it
with ``NodeRuntime.spawn_remote(peer, behavior, publish=...)``. That keeps
the worker binary generic: behaviors live in driver-side code (any
picklable module-level callable / Actor subclass / KernelDecl) and are
shipped at spawn time, the same way CAF ships typed actor messages to a
remote ``middleman``.

The worker binds ``cuda:0`` (its own CUDA context) unless ``device`` /
``--device`` asks for another device or the CPU; without a card it
raises :class:`LookupError`. :func:`run_worker` is the library entry
point the multi-process tests and the serve mesh run in their child
processes; start it with ``multiprocessing.get_context("spawn")``, never
``fork`` (a driver that has touched CUDA cannot fork safely), which is
why it is an importable module-level function.
"""
from __future__ import annotations

import argparse
from typing import Optional, Tuple

__all__ = ["run_worker", "main"]


def run_worker(addr: Tuple[str, int], name: str, *,
               compress: bool = False,
               max_workers: int = 8,
               timeout: Optional[float] = None,
               device=None) -> None:
    """Connect to the driver at ``addr`` and serve until it disconnects.

    ``device`` is the worker system's device (``None``: ``cuda:0``).
    Blocks in ``NodeRuntime.join()``; on return the local actor system is
    shut down. Runs in a fresh process, so imports stay inside."""
    from repro_torch.core import ActorSystem
    from repro_torch.net import NodeRuntime
    from repro_torch.serve.mesh import local_replica_stats

    system = ActorSystem(name, max_workers=max_workers, device=device)
    try:
        node = NodeRuntime(system, name=name, compress=compress)
    except BaseException:
        system.shutdown()
        raise
    # any EngineReplica the driver spawn_remotes here reports its load
    # through peer_stats (a mesh router reads this out of band of the
    # per-replica "stats" message path)
    node.add_stats_provider("serve", local_replica_stats)
    node.add_stats_provider("device", lambda: str(node.unspill_device))
    try:
        node.connect(tuple(addr))
        node.join(timeout=timeout)
    finally:
        node.shutdown()
        system.shutdown()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--connect", required=True, metavar="HOST:PORT",
                   help="driver node address to dial")
    p.add_argument("--name", default=None, help="cluster-unique node name")
    p.add_argument("--compress", action="store_true",
                   help="int8-compress float refs at the wire boundary")
    p.add_argument("--max-workers", type=int, default=8,
                   help="actor scheduler threads")
    p.add_argument("--device", default=None,
                   help="the worker's device (default: cuda:0; 'cpu' asks "
                        "for the CPU)")
    args = p.parse_args(argv)
    host, _, port = args.connect.rpartition(":")
    import os
    run_worker((host, int(port)), args.name or f"worker-{os.getpid():x}",
               compress=args.compress, max_workers=args.max_workers,
               device=args.device)


if __name__ == "__main__":
    main()
