"""device_idle.prefill: 1 - the union of the device's intervals over the
traced window, in %."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["summary"]["busy_s"] / tr["window_s"])
