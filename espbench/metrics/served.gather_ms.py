"""Milliseconds a tick of the fleet's gather spans (`gather_packed` and
`gather`: the sessions' pumps, the native pops, the audio gather and
the OSD), over the ticks of the traced stretch, from the fleet's timers
(Fleet.timers, kept by the served entry's SpanTimers)."""

LAYER = "session feed + gather"
UNIT = "ms/tick"
SOURCE = "program_span"
MOVES = "served_streams"
SPANS = ("gather_packed", "gather")


def read(ctx):
    timers, ticks = ctx.get("timers_s"), ctx.get("ticks")
    if not timers or not ticks:
        return None
    return 1e3 * sum(timers.get(n, 0.0) for n in SPANS) / ticks
