"""Kilobytes (1,000 bytes) a tick of the HostPool workers' pickled
replies (`pool.reply_bytes`: every worker's shard of the tick's chain
inputs, feed counts and events), over the ticks of the traced stretch,
from the "fleet" records that Fleet.run_chunk_full_pooled appends while
a profiler records (runtime/telemetry.py).  A count of the transfer's
work, read beside `pooled.transfer_ms`, not a target."""

LAYER = "session feed + gather"
UNIT = "KB/tick"
SOURCE = "program_counter"
MOVES = "served_streams"


def read(ctx):
    try:
        from espflix_tpu_torch.runtime import telemetry
    except ImportError:
        return None
    ticks = ctx.get("ticks")
    recs = telemetry.traced("fleet", ticks)
    if recs is None or any("pool.reply_bytes" not in r["counters"]
                           for r in recs):
        return None
    return sum(r["counters"]["pool.reply_bytes"] for r in recs) / 1e3 \
        / ticks
