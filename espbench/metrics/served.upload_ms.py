"""Milliseconds a tick of the fleet's `upload` spans: the copy of a
chunk's stacked inputs to the card (models/mpeg1.xs_to_torch), inside
`batch_assemble`, over the ticks of the traced stretch, from the
fleet's timers (Fleet.timers, kept by the served entry's
SpanTimers)."""

LAYER = "batch assembly + upload"
UNIT = "ms/tick"
SOURCE = "program_span"
MOVES = "served_streams"
SPANS = ("upload",)


def read(ctx):
    timers, ticks = ctx.get("timers_s"), ctx.get("ticks")
    if not timers or not ticks or not any(n in timers for n in SPANS):
        return None
    return 1e3 * sum(timers.get(n, 0.0) for n in SPANS) / ticks
