"""The chain's kernels against the card's memory bandwidth: the least
seconds the traced ticks' bytes need at the published peak
(roofline.py, counted from the inputs and the reference's parse) over
the seconds the profiler saw kernels run in those ticks, in %."""

from espbench import roofline, stats

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "chain_streams"


def read(ctx):
    prof = ctx["profile"]
    kernels = [d[:2] for d in prof.device if d[3] == "kernel"]
    kernel_s = stats.busy_s(kernels, prof.stretch) if prof.stretch else 0.0
    if not ctx.get("bytes") or kernel_s <= 0:
        return None
    return 100.0 * roofline.least_seconds(ctx["bytes"]) / kernel_s
