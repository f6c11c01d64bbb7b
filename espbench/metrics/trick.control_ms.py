"""Milliseconds a tick of the fleet's `control` spans (Fleet.apply_keys:
the remote's keys dispatched to the sessions between chunks, the seeks'
index reads and stream opens), over the ticks of the traced stretch,
from the fleet's timers (Fleet.timers, kept by the served entry's
SpanTimers).  Nothing where the program spans no `control`."""

LAYER = "control"
UNIT = "ms/tick"
SOURCE = "program_span"
MOVES = "served_streams"
SPANS = ("control",)


def read(ctx):
    timers, ticks = ctx.get("timers_s"), ctx.get("ticks")
    if not timers or not ticks or not any(n in timers for n in SPANS):
        return None
    return 1e3 * sum(timers.get(n, 0.0) for n in SPANS) / ticks
