"""Milliseconds a tick of the fleet's `readback` spans: the copies of a
chunk's flags, checksums and taps to the host, timed inside `host_sync`
after it has waited for the card (which it does only while a profiler
records), over the ticks of the traced stretch, from the fleet's timers
(Fleet.timers, kept by the served entry's SpanTimers)."""

LAYER = "serving entry"
UNIT = "ms/tick"
SOURCE = "program_span"
MOVES = "served_streams"
SPANS = ("readback",)


def read(ctx):
    timers, ticks = ctx.get("timers_s"), ctx.get("ticks")
    if not timers or not ticks or not any(n in timers for n in SPANS):
        return None
    return 1e3 * sum(timers.get(n, 0.0) for n in SPANS) / ticks
