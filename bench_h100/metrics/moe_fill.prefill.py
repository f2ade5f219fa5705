"""moe_fill.prefill: the top-k assignments the MoE layers kept over the
expert capacity slots they allocated (the program's counters
``moe.filled`` and ``moe.slots``), in %: an empty slot is expert FLOPs
on zeros; at capacity factor 1.25 at most 80 % (moves
prefill_tokens_per_s)."""
from bench_h100.metrics._program import counter


def read(ctx):
    slots, filled = counter("moe.slots"), counter("moe.filled")
    if not slots or filled is None:
        return None
    return 100.0 * filled / slots
