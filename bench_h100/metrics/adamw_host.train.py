"""adamw_host.train: the host time of the AdamW update a traced step (the
program's ``optim.adamw`` spans: global norm, clip and the loop over
the leaves), in ms (moves train_tokens_per_s)."""
from bench_h100.metrics._program import durations_s


def read(ctx):
    tr = ctx["trace"]
    d = durations_s("optim.adamw")
    if not d or not tr or not tr.get("steps"):
        return None
    return 1e3 * sum(d) / tr["steps"]
