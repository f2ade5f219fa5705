"""What the per-layer readers share: the frozen count of the traced
requests or steps, by the configuration's counts (``spec.counts``)."""
from __future__ import annotations

from ..spec import counts


def traced_flops(ctx) -> float:
    run, tr = ctx["run"], ctx["trace"]
    c = counts(ctx["cell"].config_name)
    if "requests" in tr:
        return sum(c.prefill_flops(run, r.batch, r.seq)
                   for r in tr["requests"])
    mix = ctx["cell"].traffic
    return tr["steps"] * c.train_flops(run, int(mix["batch"]), int(mix["seq"]))


def traced_flash_bound_s(ctx) -> float:
    run, tr = ctx["run"], ctx["trace"]
    c = counts(ctx["cell"].config_name)
    return sum(c.flash_bound_s(run, r.batch, r.seq) for r in tr["requests"])
