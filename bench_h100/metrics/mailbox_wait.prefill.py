"""mailbox_wait.prefill: the mean latency of an actor hop, in ms: a
message's wait in its actor's mailbox (the program's ``actor.mailbox``
spans) less the time the actor spent of it in earlier bodies (its
``actor.receive`` spans), over every message of the traced window (moves
prefill_tokens_per_s). With two requests in flight a message mostly
waits out the stage's previous body, which is the stage's own time and
left out here."""
import statistics

from bench_h100.metrics._program import hops_s


def read(ctx):
    h = hops_s()
    return None if h is None else 1e3 * statistics.fmean(h)
