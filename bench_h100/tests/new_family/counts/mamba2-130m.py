"""mamba2-130m's counts: every layer a Mamba-2 SSD mixer and no layer
attends, so B6 is never launched.

Model FLOPs: 2 per multiply-add of every weight a token passes through
(``in_proj`` d × (2·di + 2·g·N + H), ``out_proj`` di × d, the tied LM
head), plus the recurrence in its linear-time form, 4·N·P per head and
token (the state's update and its read-out)."""


def _per_token(run):
    d, ssm = run["d_model"], run["ssm"]
    di = ssm["expand"] * d
    n, p, g = ssm["state_dim"], ssm["head_dim"], ssm.get("n_groups", 1)
    h = di // p
    weights = run["n_layers"] * (d * (2 * di + 2 * g * n + h) + di * d) + \
        d * run["vocab_size"]
    return weights, run["n_layers"] * 4 * h * n * p


def prefill_flops(run, batch, seq):
    weights, recurrence = _per_token(run)
    return (2.0 * weights + recurrence) * batch * seq


def flash_bound_s(run, batch, seq):
    return 0.0
