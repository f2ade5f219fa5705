"""Typed dataflow-graph composition (paper §3.5), on the port.

Builds the diamond

    source ──► broadcast(2) ──► double ──► zip_join ──► add2 (sink)
                        └─────► sub3  ──────┘

checks that the topology validates at build time, runs it with no host
transfer on the interior edges, then shows a type error caught at build
time, before anything is spawned:

    PYTHONPATH=src python -m repro_torch.examples.graph_diamond
"""
from __future__ import annotations

import argparse
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core import (ActorSystem, Graph, In, NDRange, Out,
                              PortTypeMismatchError, dim_vec, kernel,
                              memory_stats, reset_transfer_stats,
                              transfer_count)

N = 1024


@kernel(In(torch.float32), Out(torch.float32), nd_range=NDRange(dim_vec(N)))
def double(x):
    return x * 2.0


@kernel(In(torch.float32), Out(torch.float32), nd_range=NDRange(dim_vec(N)))
def sub3(x):
    return x - 3.0


@kernel(In(torch.float32), In(torch.float32), Out(torch.float32),
        nd_range=NDRange(dim_vec(N)))
def add2(a, b):
    return a + b


def run(device=None) -> Dict[str, Any]:
    """Build and run the diamond on ``device`` (``cuda:0`` by default).
    Returns the placements, the output (equal to ``xs*2 + xs - 3``), the
    transfer and read-back counts of the ``ask`` and the message of the
    int32 → float32 wiring's ``PortTypeMismatchError``."""
    with ActorSystem(max_workers=8, device=device) as system:
        g = Graph(system, name="diamond")
        x = g.source("x", torch.float32, shape=(N,))
        left, right = g.broadcast(x, 2)
        j1, j2 = g.zip_join(g.apply(double, left), g.apply(sub3, right))
        g.output(g.apply(add2, j1, j2))

        diamond = g.build()          # validate → place → lower → spawn
        placements = {k: v.name for k, v in diamond.placements.items()}

        xs = np.arange(N, dtype=np.float32)
        reset_transfer_stats()
        out = np.asarray(diamond.ask(xs))
        transfers, readbacks = transfer_count(), memory_stats()["readbacks"]
        np.testing.assert_allclose(out, xs * 2 + xs - 3, rtol=1e-6)

        # the typed-actor check the paper gets from CAF: an int32 source
        # wired into a float32 kernel fails at build time, with the
        # offending node path in the message
        bad = Graph(system, name="bad")
        s = bad.source("x", torch.int32, shape=(N,))
        bad.output(bad.apply(double, s))
        try:
            bad.build()
        except PortTypeMismatchError as exc:
            error = str(exc)
        else:
            raise AssertionError("the int32 → float32 wiring was built")
    return {"placements": placements, "input": xs, "output": out,
            "transfers": transfers, "readbacks": readbacks, "error": error}


def main(argv=None) -> None:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    r = run()
    print("placements:", r["placements"])
    print(f"diamond ok: transfers={r['transfers']} "
          f"readbacks={r['readbacks']} "
          "(interior edges stayed device-resident)")
    print(f"caught at build time: {r['error']}")


if __name__ == "__main__":
    main()
