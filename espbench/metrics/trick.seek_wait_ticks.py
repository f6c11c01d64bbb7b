"""Ticks from a seek to the lane's first presented picture, that tick
included (`control.seek_wait` / `control.seeks`: lane-ticks waited over
seeks), over the traced stretch, from the "fleet" records that
Fleet.run_chunk_full appends while a profiler records
(runtime/telemetry.py).  Nothing where the records hold no such counter
or no seek."""

LAYER = "control"
UNIT = "ticks"
SOURCE = "program_counter"
MOVES = "served_streams"


def read(ctx):
    try:
        from espflix_tpu_torch.runtime import telemetry
    except ImportError:
        return None
    recs = telemetry.traced("fleet", ctx.get("ticks"))
    keys = ("control.seeks", "control.seek_wait")
    if recs is None or any(k not in r["counters"] for r in recs
                           for k in keys):
        return None
    seeks = sum(r["counters"]["control.seeks"] for r in recs)
    if not seeks:
        return None
    return sum(r["counters"]["control.seek_wait"] for r in recs) / seeks
