"""The share of playing lane-ticks (`feed.lane_ticks`) on the native
fast path: 100 x (1 - `feed.slow_lane_ticks` / `feed.lane_ticks`), the
slow ones being playing lanes the packed gather served one by one (as a
lane whose session fell back to the Python feed is), over the traced
stretch, from the "fleet" records that Fleet.run_chunk_full appends
while a profiler records (runtime/telemetry.py).  Nothing where the
records hold no such counter."""

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
    if recs is None or any("feed.slow_lane_ticks" not in r["counters"]
                           for r in recs):
        return None
    lane_ticks = sum(r["counters"]["feed.lane_ticks"] for r in recs)
    if not lane_ticks:
        return None
    return 100.0 * (1 - sum(r["counters"]["feed.slow_lane_ticks"]
                            for r in recs) / lane_ticks)
