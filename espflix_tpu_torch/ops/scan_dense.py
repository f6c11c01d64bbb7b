"""Emission log -> lane-major dense decode buffers.

The scanner (ops/vlc_scan.py) emits at most one (flat index, value)
pair per scan row per step.  This module re-exports the host-side
scan-row -> (lane, MB row) permutation (``row_perm``) and the mesh's
per-shard packing (``pack_slice_rows_sharded``) of ops/host_pack.py,
and holds the JAX package's densify (scan_dense.py:139-310) with its
signatures, written as integer scatters and one gather:
``log_to_dense_rows`` (each row's emissions into its MB row's window)
and ``assemble_dense_T`` / ``assemble_dense`` (the windows into the
lanes' buffers).  Together they are the plain form of K1's stores, and
the CUDA scan (K1) keeps the same rules:

  * each scan row owns ONE MB row (``rows[r] * mb_width`` ..+mb_width);
    an emission whose MB falls outside it is dropped and flags the
    row's lane;
  * only the row that ``perm`` selects for its (lane, MB row) writes;
    the first claim wins, a duplicate row's emissions are discarded,
    and an unclaimed MB row stays zero;
  * emissions into one slot add up, as the JAX contractions do:
    coefficients as int16 (wrapping), nfinal as int32 (the scanner's
    counts, at most 64, which bfloat16 holds exactly), and a record as
    four byte-quarter sums recombined to ``lo16 | (hi15 << 16)``
    (bit 31 cleared).  Well-formed streams emit each slot at most once.
"""

from __future__ import annotations

import torch

from espflix_tpu_torch.ops.host_pack import (  # noqa: F401
    pack_slice_rows_sharded, row_perm)
from espflix_tpu_torch.ops.intwrap import wrap16, wrap32


def log_to_dense_rows(log_idx, log_val, rowbase_mb, *, mb_width: int,
                      mb_count: int, transposed: bool = False):
    """[T, R] logs -> per-row dense windows (scan_dense.py:175-268).

    log_idx / log_val int32[T, R]; rowbase_mb int32[R], the first MB of
    each row's MB row.  Returns (coef_rows int16[R, mb_width*384], or
    int16[R, 64, mb_width*6] when `transposed`; aux_rows int32[R,
    mb_width, 8] -- columns 0-5 nfinal, 6 the record's low 16 bits, 7
    its bits 16-30; dropped bool[R]: the row emitted a real index
    outside its window).  The JAX form contracts one-hot operands in
    bfloat16 with float32 sums; here each slot's emissions are summed
    as integers, which is the same function wherever those float32 sums
    are exact (below 2^24 in a slot):
      * coefficients: the int16 wrap of the sum of each emission's int16
        wrap (as its lo/hi byte halves);
      * nfinal: the sum of the values rounded to bfloat16, as int32;
      * the record: each byte quarter summed, then OR-ed back together
        (quarters past 255 overlap, as in JAX)."""
    dev = log_idx.device
    li = log_idx.t().long()                              # [R, T]
    lv = log_val.t()
    R = li.shape[0]
    TC = mb_width * 6
    base_c = mb_count * 7
    trash = base_c + mb_count * 384
    rb = rowbase_mb.long()[:, None]
    row = torch.arange(R, device=dev)[:, None].expand_as(li)

    is_coef = (li >= base_c) & (li < trash)
    mbg = torch.div(li - base_c, 384, rounding_mode="floor")
    r384 = li - base_c - mbg * 384
    ok_c = is_coef & (mbg - rb >= 0) & (mbg - rb < mb_width)
    tile_c = (mbg - rb) * 6 + (r384 >> 6)
    pos_c = r384 & 63

    is_nfin = (li >= mb_count) & (li < base_c)
    mbn = torch.div(li - mb_count, 6, rounding_mode="floor")
    slot_n = li - mb_count - mbn * 6
    ok_n = is_nfin & (mbn - rb >= 0) & (mbn - rb < mb_width)

    is_rec = (li >= 0) & (li < mb_count)
    ok_r = is_rec & (li - rb >= 0) & (li - rb < mb_width)
    dropped = ((li < trash) & ~(ok_c | ok_n | ok_r)).any(dim=1)

    def accumulate(size, flat, mask, values):
        out = torch.zeros(size, dtype=torch.int64, device=dev)
        out.index_put_((flat[mask],), values[mask], accumulate=True)
        return out

    v16 = wrap16(lv).long()
    if transposed:
        flat = (row * 64 + pos_c) * TC + tile_c
        coef = wrap16(accumulate(R * 64 * TC, flat, ok_c, v16)) \
            .reshape(R, 64, TC)
    else:
        flat = (row * TC + tile_c) * 64 + pos_c
        coef = wrap16(accumulate(R * TC * 64, flat, ok_c, v16)) \
            .reshape(R, TC * 64)

    # aux: [R, mb_width, 10] -- six nfinal slots, four record quarters
    nf = lv.to(torch.bfloat16).to(torch.float64).long()
    slot = torch.where(is_rec, 6, slot_n)
    flat = (row * mb_width + torch.where(is_rec, li - rb, mbn - rb)) * 10
    aux = torch.zeros(R * mb_width * 10, dtype=torch.int64, device=dev)
    aux.index_put_(((flat + slot)[ok_n],), nf[ok_n], accumulate=True)
    lv64 = lv.long()
    for k in range(4):
        aux.index_put_(((flat + 6 + k)[ok_r],),
                       ((lv64 >> (8 * k)) & 0xFF)[ok_r], accumulate=True)
    oi = wrap32(aux).reshape(R, mb_width, 10)
    rec = wrap32(oi[..., 6].long() | (oi[..., 7].long() << 8)
                 | (oi[..., 8].long() << 16) | (oi[..., 9].long() << 24))
    aux_rows = torch.cat([oi[..., :6], (rec & 0xFFFF)[..., None],
                          ((rec >> 16) & 0x7FFF)[..., None]], dim=2)
    return coef, aux_rows, dropped


def _take_rows(rows, perm):
    """rows[perm] with index rows.shape[0] selecting a zero row."""
    pad = torch.zeros((1,) + tuple(rows.shape[1:]), dtype=rows.dtype,
                      device=rows.device)
    return torch.cat([rows, pad])[perm.long()]


def _assemble_aux(aux_rows, perm, n_lanes: int, mb_count: int):
    aux = _take_rows(aux_rows, perm).reshape(n_lanes, mb_count, 8)
    recs = aux[:, :, 6] | (aux[:, :, 7] << 16)
    return recs, aux[:, :, 0:6].reshape(n_lanes, mb_count * 6)


def assemble_dense_T(coef_rows_T, aux_rows, perm, *, n_lanes: int,
                     mb_width: int, mb_height: int):
    """Transposed per-row windows ([NS, 64, mb_width*6]) -> (coeffs_T
    int16[N, 64, MB*6], recs int32[N, MB], nfinal int32[N, MB*6])
    (scan_dense.py:271-289); perm as in assemble_dense."""
    mb_count = mb_width * mb_height
    coeffs_T = _take_rows(coef_rows_T, perm) \
        .reshape(n_lanes, mb_height, 64, mb_width * 6).transpose(1, 2) \
        .reshape(n_lanes, 64, mb_count * 6)
    return (coeffs_T, *_assemble_aux(aux_rows, perm, n_lanes, mb_count))


def assemble_dense(coef_rows, aux_rows, perm, *, n_lanes: int,
                   mb_width: int, mb_height: int):
    """Per-row windows -> lane-major dense buffers by one gather
    (scan_dense.py:292-310): coef_rows int16[NS, mb_width*384] and
    aux_rows int32[NS, mb_width, 8] in scan-row order; perm
    int32[n_lanes*mb_height] picks each (lane, MB row)'s scan row, NS
    meaning none (a zero row).  Returns (coeffs int16[N, MB*384], recs
    int32[N, MB], nfinal int32[N, MB*6])."""
    mb_count = mb_width * mb_height
    coeffs = _take_rows(coef_rows, perm).reshape(n_lanes, mb_count * 384)
    return (coeffs, *_assemble_aux(aux_rows, perm, n_lanes, mb_count))
