"""Kilobytes (1,000 bytes) a tick that the sessions' streamers returned
(`feed.bytes_read`), over the ticks of the traced stretch, from the
"fleet" records that Fleet.run_chunk_full appends while a profiler
records (runtime/telemetry.py).  A count of the gather's work, read
beside its times, not a target."""

LAYER = "session feed + gather"
UNIT = "KB/tick"
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
    return sum(r["counters"]["feed.bytes_read"] for r in recs) / 1e3 \
        / ctx["ticks"]
