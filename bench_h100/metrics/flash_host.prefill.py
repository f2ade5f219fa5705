"""flash_host.prefill: the median host time of one flash-attention call
on the card, its operands prepared and the kernel launched (the
program's ``kernel.flash_attention`` spans), in us (moves
prefill_tokens_per_s)."""
from bench_h100.metrics._program import median_s


def read(ctx):
    m = median_s("kernel.flash_attention")
    return None if m is None else 1e6 * m
