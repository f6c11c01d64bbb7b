"""Milliseconds a tick of the fleet's native feed calls: each pump
round's `gather.pop` (one pop of every pending lane's picture straight
into the batch layout) and `gather.feed` (one call feeding the round's
reads), inside `gather_packed`, over the ticks of the traced stretch,
from the fleet's timers (Fleet.timers, kept by the served entry's
SpanTimers)."""

LAYER = "session feed + gather"
UNIT = "ms/tick"
SOURCE = "program_span"
MOVES = "served_streams"
SPANS = ("gather.pop", "gather.feed")


def read(ctx):
    timers, ticks = ctx.get("timers_s"), ctx.get("ticks")
    if not timers or not ticks or not any(n in timers for n in SPANS):
        return None
    return 1e3 * sum(timers.get(n, 0.0) for n in SPANS) / ticks
