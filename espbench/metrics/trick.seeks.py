"""Seeks a tick: keys after which a lane's stream reopened
(`control.seeks`, counted by Fleet.apply_keys), over the ticks of the
traced stretch, from the "fleet" records that Fleet.run_chunk_full
appends while a profiler records (runtime/telemetry.py; a chunk's record
holds the keys applied just before it).  Nothing where the records hold
no such counter."""

LAYER = "control"
UNIT = "seeks/tick"
SOURCE = "program_counter"
MOVES = "served_streams"


def read(ctx):
    try:
        from espflix_tpu_torch.runtime import telemetry
    except ImportError:
        return None
    recs = telemetry.traced("fleet", ctx.get("ticks"))
    if recs is None or any("control.seeks" not in r["counters"]
                           for r in recs):
        return None
    return sum(r["counters"]["control.seeks"] for r in recs) / ctx["ticks"]
