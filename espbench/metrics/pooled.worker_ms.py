"""Milliseconds a tick of the slowest HostPool worker's own gather
(`pool.worker_us`: its sessions' pumps, pops, row packing and SBC, as
the worker times it), over the ticks of the traced stretch, from the
"fleet" records that Fleet.run_chunk_full_pooled appends while a
profiler records (runtime/telemetry.py).  Nothing where the records
hold no such counter."""

LAYER = "session feed + gather"
UNIT = "ms/tick"
SOURCE = "program_counter"
MOVES = "served_streams"


def read(ctx):
    try:
        from espflix_tpu_torch.runtime import telemetry
    except ImportError:
        return None
    ticks = ctx.get("ticks")
    recs = telemetry.traced("fleet", ticks)
    if recs is None or any("pool.worker_us" not in r["counters"]
                           for r in recs):
        return None
    return sum(r["counters"]["pool.worker_us"] for r in recs) / 1e3 / ticks
