"""Milliseconds a tick of the chain's audio on the card: the stages
"sbc" (K6, the SBC decode) and "pdm" (the selects and K5),
over the ticks of the traced stretch, from the "chain" records that
runtime/chain.FullChain appends while a profiler records
(runtime/telemetry.ChainSpans: a CUDA event at the end of each stage,
each stage timed from the event before it)."""

LAYER = "chain"
UNIT = "ms/tick"
SOURCE = "program_span"
MOVES = "chain_streams"
STAGES = ("sbc", "pdm")


def read(ctx):
    try:
        from espflix_tpu_torch.runtime import telemetry
    except ImportError:
        return None
    recs = telemetry.traced("chain", ctx.get("ticks"))
    if recs is None:
        return None
    return 1e3 * sum(r["device"][s] for r in recs for s in STAGES) \
        / ctx["ticks"]
