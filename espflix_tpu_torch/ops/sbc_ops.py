"""Batched SBC decode primitives (exact int32 arithmetic).

The port of espflix_tpu.ops.sbc_ops: A2DP bit allocation as a
fixed-trip masked loop, MSB-first bit-field extraction from big-endian
words, and the exact two-step IQUANT division.  Plain PyTorch: the JAX
package leaves these stages to XLA, not to a Pallas kernel.
"""

from __future__ import annotations

import torch

from espflix_tpu_torch.core import sbc_tables as T
from espflix_tpu_torch.ops.intwrap import wrap32


def bit_allocation_batched(sf, bitpool, frequency, allocation,
                           max_iters: int = 48):
    """Vectorized A2DP 12.6.3 allocation.

    sf: int32[..., 8] scale factors (one channel per row).
    bitpool/frequency/allocation: int32[...].  Returns bits int32[..., 8].
    """
    i32 = torch.int32
    off8 = torch.as_tensor(T.OFFSET_8, dtype=i32, device=sf.device)
    off = off8[frequency.long()]                        # [..., 8]
    loud = sf - off
    loud = torch.where(loud > 0, loud >> 1, loud)
    bitneed = torch.where(allocation[..., None] == 1, sf,
                          torch.where(sf == 0, -5, loud))
    max_bitneed = bitneed.amax(dim=-1)

    def slicecount_of(bitslice):
        bs = bitslice[..., None]
        in_win = (bitneed > bs + 1) & (bitneed < bs + 16)
        eq = bitneed == bs + 1
        return (in_win.sum(-1) + 2 * eq.sum(-1)).to(i32)

    # do-while: bitslice--, bitcount+=slicecount, recompute slicecount,
    # until bitcount+slicecount >= bitpool
    bitslice = max_bitneed + 1
    bitcount = torch.zeros_like(max_bitneed)
    slicecount = torch.zeros_like(max_bitneed)
    done = torch.zeros_like(max_bitneed, dtype=torch.bool)
    for _ in range(max_iters):
        nbs = torch.where(done, bitslice, bitslice - 1)
        nbc = torch.where(done, bitcount, bitcount + slicecount)
        nsc = torch.where(done, slicecount, slicecount_of(nbs))
        done = done | (nbc + nsc >= bitpool)
        bitslice, bitcount, slicecount = nbs, nbc, nsc

    exact = bitcount + slicecount == bitpool
    bitcount = torch.where(exact, bitcount + slicecount, bitcount)
    bitslice = torch.where(exact, bitslice - 1, bitslice)

    bs = bitslice[..., None]
    bits = torch.where(bitneed < bs + 2, 0,
                       torch.minimum(bitneed - bs,
                                     torch.full_like(bitneed, 16)))
    bits = bits.clone()
    # first correction pass (sequential over subbands, carries bitcount)
    for sb in range(8):
        b = bits[..., sb]
        can = bitcount < bitpool
        inc1 = can & (b >= 2) & (b < 16)
        set2 = can & ~inc1 & (bitneed[..., sb] == bitslice + 1) & \
            (bitpool > bitcount + 1)
        nb = torch.where(inc1, b + 1, torch.where(set2, 2, b))
        bitcount = bitcount + torch.where(inc1, 1, torch.where(set2, 2, 0))
        bits[..., sb] = nb
    # second correction pass
    for sb in range(8):
        b = bits[..., sb]
        inc = (bitcount < bitpool) & (b < 16)
        bits[..., sb] = torch.where(inc, b + 1, b)
        bitcount = bitcount + torch.where(inc, 1, 0)
    return bits.to(i32)


def extract_bits(words, bit_offsets, widths):
    """MSB-first bit fields from big-endian 32-bit words.

    words: int32[..., W] (uint32 bit patterns); bit_offsets/widths:
    int32[..., K].  Returns int32[..., K] (0 where width == 0).  The
    first word past the buffer reads 0, the second word clamps to the
    last one, as in the JAX one-hot selects."""
    W = words.shape[-1]
    w64 = words.long() & 0xFFFFFFFF
    w_idx = (bit_offsets >> 5).long()
    off = (bit_offsets & 31).long()
    w0 = torch.gather(w64, -1, w_idx.clamp(0, W - 1))
    w0 = torch.where(w_idx < W, w0, 0)
    w1 = torch.gather(w64, -1, (w_idx + 1).clamp(max=W - 1))
    hi = (w0 << off) & 0xFFFFFFFF
    lo = torch.where(off == 0, 0, w1 >> (32 - off))
    win = hi | lo
    sh = (32 - widths.long()).clamp(0, 31)
    val = wrap32(win >> sh)
    return torch.where(widths > 0, val, 0)


def iquant_exact(raw, level, scale):
    """((raw<<1|1) << scale) // (2^level - 1) - (1<<scale), exact in
    int32 (level is 0 or 2..16; result only used where level>0)."""
    one = torch.ones_like(level)
    s = (raw << 1) | 1
    d = torch.clamp((one << level) - 1, min=1)
    s1 = torch.clamp(scale, max=13)
    s2 = scale - s1
    a = s << s1
    q1 = torch.div(a, d, rounding_mode="floor")
    r1 = a - q1 * d
    q = (q1 << s2) + torch.div(r1 << s2, d, rounding_mode="floor")
    return q - (one << scale)
