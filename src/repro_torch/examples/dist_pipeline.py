"""Network-transparent two-process pipeline (paper §2.1/§3.5), on the
port.

Spawns a worker process, connects it as a cluster node, and runs a
3-stage pipeline whose middle stage is a ``RemoteActorRef``: the stage
boundary crosses the wire as exactly one int8-compressed spill/unspill
pair per hop (asserted on both processes' ``memory_stats()`` counters).
Then it SIGKILLs the worker mid-run to show cross-node supervision:
local monitors get a ``DownMessage`` and the dead node's in-flight chunks
are re-issued on the surviving local worker, every result exactly once.
Both processes bind ``cuda:0`` unless :func:`run` is given a device.

The demo's logic lives in ``repro_torch.net.demo`` (module-level, so
that the spawned child can import it); this module is the runnable front
door:

    PYTHONPATH=src python -m repro_torch.examples.dist_pipeline
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict

from repro_torch.net import demo


def run(device=None) -> Dict[str, Any]:
    """``net.demo.main`` at its defaults on ``device`` (``cuda:0`` by
    default): its summary, after its exactly-once and
    one-spill-pair-a-hop assertions."""
    return demo.main(device=device)


def main(argv=None) -> None:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    summary = run()
    print(json.dumps(
        {k: (sorted(v) if isinstance(v, set) else v)
         for k, v in summary.items()}, indent=2, default=str))
    print("\nPASS: 3-stage cross-node pipeline, one spill/unspill pair per "
          "hop on each side, DownMessage + exactly-once re-issue after "
          "node death.")


if __name__ == "__main__":
    main()
