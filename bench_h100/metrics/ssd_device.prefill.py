"""ssd_device.prefill: the device's time in the SSD mixers' chunk loops
over the traced window, in % (moves prefill_tokens_per_s). The program
counts it as ``ssm.scan_device_ns`` (``repro_torch.trace.device_time``):
on the card two CUDA events on the stage's stream around each ``ssm.scan``
(the loop over the chunks, the skip and the gate), so it is the time of
the work those spans launched, whether or not the host waited there; on
the CPU the host's time in them. None where the program keeps no such
counter."""
from bench_h100.metrics._program import counter


def read(ctx):
    tr = ctx["trace"]
    ns = counter("ssm.scan_device_ns")
    if not ns or not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * ns / 1e9 / tr["window_s"]
