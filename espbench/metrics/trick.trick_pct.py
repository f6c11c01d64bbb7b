"""The share of playing lane-ticks (`feed.lane_ticks`) that were
fast-forwarding or rewinding at the tick's start
(`feed.trick_lane_ticks`), in %, over the traced stretch, from the
"fleet" records that Fleet.run_chunk_full appends while a profiler
records (runtime/telemetry.py).  Nothing where the records hold no such
counter."""

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
    if recs is None or any("feed.trick_lane_ticks" not in r["counters"]
                           for r in recs):
        return None
    lane_ticks = sum(r["counters"]["feed.lane_ticks"] for r in recs)
    if not lane_ticks:
        return None
    return 100.0 * sum(r["counters"]["feed.trick_lane_ticks"]
                       for r in recs) / lane_ticks
