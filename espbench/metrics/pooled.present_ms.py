"""Milliseconds a tick of the pooled fleet's `present` spans: a chunk's
presentation and resync round trip to the HostPool's workers after it
(Fleet.run_chunk_full_pooled), over the ticks of the traced
stretch, from the fleet's timers (Fleet.timers, kept by the served
entry's SpanTimers)."""

LAYER = "serving entry"
UNIT = "ms/tick"
SOURCE = "program_span"
MOVES = "served_streams"
SPANS = ("present",)


def read(ctx):
    timers, ticks = ctx.get("timers_s"), ctx.get("ticks")
    if not timers or not ticks or not any(n in timers for n in SPANS):
        return None
    return 1e3 * sum(timers.get(n, 0.0) for n in SPANS) / ticks
