"""flash_roofline.prefill: the flash-attention kernel's share of its roofline,
in %: the sum over its traced launches of the larger of FLOPs at the bf16
peak and bytes at HBM's (the frozen causal count of each request's shape,
one launch a layer), over the device time of the operations whose names
hold ``flash_attention``. None where the trace holds no such launch."""
from bench_h100.metrics._common import traced_flash_bound_s
from bench_h100.trace import device_seconds


def read(ctx):
    tr = ctx["trace"]
    t = device_seconds(tr["summary"], "flash_attention") if tr else 0.0
    if t <= 0:
        return None
    return 100.0 * traced_flash_bound_s(ctx) / t
