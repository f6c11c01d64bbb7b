"""The card's idle share over the traced stretch of the chain cells:
100 x (1 - the union of kernel, copy and set intervals / the stretch),
from torch.profiler's CUDA trace."""

from espbench import stats

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "chain_streams"


def read(ctx):
    prof = ctx["profile"]
    if prof.stretch is None or not prof.device:
        return None
    return stats.idle_pct([d[:2] for d in prof.device], prof.stretch)
