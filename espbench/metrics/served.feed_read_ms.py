"""Milliseconds a tick of the fleet's `gather.read` spans: each pump
round's streamer reads for the lanes that found no picture, inside
`gather_packed`, over the ticks of the traced stretch, from the fleet's
timers (Fleet.timers, kept by the served entry's SpanTimers)."""

LAYER = "session feed + gather"
UNIT = "ms/tick"
SOURCE = "program_span"
MOVES = "served_streams"
SPANS = ("gather.read",)


def read(ctx):
    timers, ticks = ctx.get("timers_s"), ctx.get("ticks")
    if not timers or not ticks or not any(n in timers for n in SPANS):
        return None
    return 1e3 * sum(timers.get(n, 0.0) for n in SPANS) / ticks
