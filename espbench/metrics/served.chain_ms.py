"""Milliseconds a tick of the chain's device span in the serving path:
from the CUDA event before a chunk's first tick to the one after its
last (runtime/telemetry.ChainSpans, "span"; the kernels, the glue and
the card's waits on the host's enqueue), over the ticks of the traced
stretch, from the "chain" records that runtime/chain.FullChain appends
while a profiler records."""

LAYER = "serving entry"
UNIT = "ms/tick"
SOURCE = "program_span"
MOVES = "served_streams"


def read(ctx):
    try:
        from espflix_tpu_torch.runtime import telemetry
    except ImportError:
        return None
    recs = telemetry.traced("chain", ctx.get("ticks"))
    if recs is None:
        return None
    return 1e3 * sum(r["device"]["span"] for r in recs) / ctx["ticks"]
