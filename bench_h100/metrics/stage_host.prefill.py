"""stage_host.prefill: the host time of the stage actors' bodies (the
program's ``stage`` spans: embedding, the layers' launches, the head)
over the traced window, in % (moves prefill_tokens_per_s)."""
from bench_h100.metrics._program import durations_s


def read(ctx):
    tr = ctx["trace"]
    d = durations_s("stage")
    if not d or not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * sum(d) / tr["window_s"]
