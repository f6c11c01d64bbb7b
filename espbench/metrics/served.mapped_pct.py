"""Percent of the bytes the sessions' pump rounds fed
(`feed.bytes_read`) that came from read-only mappings of the title
files (`feed.mapped_bytes`), over the ticks of the traced stretch, from
the "fleet" records that Fleet.run_chunk_full appends while a profiler
records (runtime/telemetry.py).  Nothing where the records hold no such
counter (a program without mapped reads) or no byte was fed."""

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
    if recs is None or any("feed.mapped_bytes" not in r["counters"]
                           for r in recs):
        return None
    fed = sum(r["counters"]["feed.bytes_read"] for r in recs)
    if not fed:
        return None
    return 100 * sum(r["counters"]["feed.mapped_bytes"] for r in recs) / fed
