"""Milliseconds a tick between the HostPool's fan-out and its last
reply unpickled (`pool_gather.wait`) less the slowest worker's own
gather (`pool.worker_us`): the messages, the pickling, the socket and
the unpickling, over the ticks of the traced stretch, from the fleet's
timers (Fleet.timers, kept by the served entry's SpanTimers) and the
"fleet" records that Fleet.run_chunk_full_pooled appends while a
profiler records (runtime/telemetry.py)."""

LAYER = "session feed + gather"
UNIT = "ms/tick"
SOURCE = "program_span"
MOVES = "served_streams"
SPAN = "pool_gather.wait"


def read(ctx):
    try:
        from espflix_tpu_torch.runtime import telemetry
    except ImportError:
        return None
    timers, ticks = ctx.get("timers_s"), ctx.get("ticks")
    if not timers or not ticks or SPAN not in timers:
        return None
    recs = telemetry.traced("fleet", ticks)
    if recs is None or any("pool.worker_us" not in r["counters"]
                           for r in recs):
        return None
    worker_ms = sum(r["counters"]["pool.worker_us"] for r in recs) / 1e3
    return (1e3 * timers[SPAN] - worker_ms) / ticks
