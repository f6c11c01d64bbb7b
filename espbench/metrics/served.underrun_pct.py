"""The share of playing lane-ticks (`feed.lane_ticks`: lanes playing,
fast-forwarding or rewinding at a tick's start) that ended the tick
with no picture (`feed.underruns`), in %, over the traced stretch, from
the "fleet" records that Fleet.run_chunk_full appends while a profiler
records (runtime/telemetry.py)."""

LAYER = "session feed + gather"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "served_streams"


def read(ctx):
    try:
        from espflix_tpu_torch.runtime import telemetry
    except ImportError:
        return None
    recs = telemetry.traced("fleet", ctx.get("ticks"))
    if recs is None:
        return None
    lane_ticks = sum(r["counters"]["feed.lane_ticks"] for r in recs)
    if not lane_ticks:
        return None
    return 100.0 * sum(r["counters"]["feed.underruns"] for r in recs) \
        / lane_ticks
