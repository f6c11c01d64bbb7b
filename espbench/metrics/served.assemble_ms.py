"""Milliseconds a tick of the fleet's `batch_assemble` spans (row
packing, the permutation, the chunk's stack and its copy to the card),
over the ticks of the traced stretch, from the fleet's timers
(Fleet.timers, kept by the served entry's SpanTimers)."""

LAYER = "batch assembly + upload"
UNIT = "ms/tick"
SOURCE = "program_span"
MOVES = "served_streams"
SPANS = ("batch_assemble",)


def read(ctx):
    timers, ticks = ctx.get("timers_s"), ctx.get("ticks")
    if not timers or not ticks:
        return None
    return 1e3 * sum(timers.get(n, 0.0) for n in SPANS) / ticks
