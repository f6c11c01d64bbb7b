"""Milliseconds a tick of the fleet's `gather_packed` spans less the
spans nested in them (`gather.pop`, `gather.read`, `gather.feed`): the
gather's own Python work -- the presentation clocks, the pops' meta
handling, the admit loop --, over the ticks of the traced stretch, from
the fleet's timers (Fleet.timers, kept by the served entry's
SpanTimers)."""

LAYER = "session feed + gather"
UNIT = "ms/tick"
SOURCE = "program_span"
MOVES = "served_streams"
CHILDREN = ("gather.pop", "gather.read", "gather.feed")


def read(ctx):
    timers, ticks = ctx.get("timers_s"), ctx.get("ticks")
    if not timers or not ticks or "gather_packed" not in timers \
            or not any(n in timers for n in CHILDREN):
        return None
    return 1e3 * (timers["gather_packed"]
                  - sum(timers.get(n, 0.0) for n in CHILDREN)) / ticks
