"""mfu.train: 6·N·T plus three times causal attention's forward FLOPs of
the traced steps over the bf16 peak times the traced window, in %
(moves train_tokens_per_s)."""
from bench_h100.metrics._common import traced_flops
from bench_h100.peaks import BF16_FLOPS


def read(ctx):
    tr = ctx["trace"]
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * traced_flops(ctx) / (BF16_FLOPS * tr["window_s"])
