"""What the per-layer readers share: the frozen count of the traced
requests or steps."""
from __future__ import annotations

from ..flops import flash_bound_s, prefill_flops, train_flops


def traced_flops(ctx) -> float:
    run, tr = ctx["run"], ctx["trace"]
    if "requests" in tr:
        return sum(prefill_flops(run, r.batch, r.seq) for r in tr["requests"])
    mix = ctx["cell"].traffic
    return tr["steps"] * train_flops(run, int(mix["batch"]), int(mix["seq"]))


def traced_flash_bound_s(ctx) -> float:
    run, tr = ctx["run"], ctx["trace"]
    return sum(run["n_layers"] * flash_bound_s(run, r.batch, r.seq)
               for r in tr["requests"])
