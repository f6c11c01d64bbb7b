"""Emission log -> lane-major dense decode buffers.

The scanner (ops/vlc_scan.py) emits at most one (flat index, value)
pair per scan row per step.  This module re-exports the host-side
scan-row -> (lane, MB row) permutation (``row_perm``) and the mesh's
per-shard packing (``pack_slice_rows_sharded``) of ops/host_pack.py,
and holds ``densify_log``: the exact semantics of
the JAX package's one-hot densify (scan_dense._decode_slots,
log_to_dense_rows and assemble_dense_T, scan_dense.py:139-286) written
as plain scatters.  The CUDA scan (K1) stores into the same buffers
directly with the same rules:

  * each scan row owns ONE MB row (``rows[r] * mb_width`` ..+mb_width);
    an emission whose MB falls outside it is dropped and flags the
    row's lane;
  * only the row that ``perm`` selects for its (lane, MB row) writes;
    the first claim wins, a duplicate row's emissions are discarded,
    and an unclaimed MB row stays zero;
  * emissions into one slot add up, as the JAX contractions do:
    coefficients as int16 (wrapping), nfinal as int32, and a record as
    four byte-quarter sums recombined to ``lo16 | (hi15 << 16)``
    (bit 31 cleared).  Well-formed streams emit each slot at most once.
"""

from __future__ import annotations

import numpy as np
import torch

from espflix_tpu_torch.ops.host_pack import (  # noqa: F401
    pack_slice_rows_sharded, row_perm)
from espflix_tpu_torch.ops.intwrap import wrap16, wrap32


def selected_rows(rows, lane_of_row, perm, mb_height: int):
    """bool[R]: scan row r is the one `perm` picks for its
    (lane, MB row)."""
    r_idx = torch.arange(rows.shape[0], device=rows.device,
                         dtype=torch.int64)
    inside = (rows >= 0) & (rows < mb_height)
    slot = lane_of_row.long() * mb_height + rows.long().clamp(
        0, mb_height - 1)
    return inside & (perm.long()[slot] == r_idx)


def densify_log(log_idx, log_val, rows, lane_of_row, perm, *,
                n_lanes: int, mb_width: int, mb_height: int):
    """[T, R] emission logs -> (coeffs_T int16[N, 64, MB*6],
    recs int32[N, MB], nfinal int32[N, MB*6], dropped bool[R])."""
    dev = log_idx.device
    mb_count = mb_width * mb_height
    BL = mb_count * 6
    base_c = mb_count + BL
    trash = base_c + mb_count * 384
    li = log_idx.t().long()                              # [R, T]
    lv = log_val.t().long()
    R = li.shape[0]
    rb = (rows.long() * mb_width)[:, None]

    is_coef = (li >= base_c) & (li < trash)
    idx2 = li - base_c
    mbg = torch.div(idx2, 384, rounding_mode="floor")
    r384 = idx2 - mbg * 384
    ok_c = is_coef & (mbg - rb >= 0) & (mbg - rb < mb_width)

    is_nfin = (li >= mb_count) & (li < base_c)
    mbn = torch.div(li - mb_count, 6, rounding_mode="floor")
    ok_n = is_nfin & (mbn - rb >= 0) & (mbn - rb < mb_width)

    is_rec = (li >= 0) & (li < mb_count)
    ok_r = is_rec & (li - rb >= 0) & (li - rb < mb_width)

    dropped = ((li < trash) & ~(ok_c | ok_n | ok_r)).any(dim=1)

    sel = selected_rows(rows, lane_of_row, perm, mb_height)[:, None]
    lane = lane_of_row.long()[:, None].expand(R, li.shape[1])

    # coefficients: [N, 64, BL] flat = (lane*64 + pos)*BL + mb*6 + blk
    m = ok_c & sel
    pos = r384 & 63
    blk = r384 >> 6
    flat = (lane * 64 + pos) * BL + mbg * 6 + blk
    v16 = wrap16(lv).long()
    acc = torch.zeros(n_lanes * 64 * BL, dtype=torch.int64, device=dev)
    acc.index_put_((flat[m],), v16[m], accumulate=True)
    coeffs_T = wrap16(acc).reshape(n_lanes, 64, BL)

    m = ok_n & sel
    flat = lane * BL + (li - mb_count)
    nf = torch.zeros(n_lanes * BL, dtype=torch.int64, device=dev)
    nf.index_put_((flat[m],), lv[m], accumulate=True)
    nfinal = wrap32(nf).reshape(n_lanes, BL)

    m = ok_r & sel
    flat = lane * mb_count + li
    q = torch.zeros((n_lanes * mb_count, 4), dtype=torch.int64,
                    device=dev)
    for k in range(4):
        q[:, k].index_put_((flat[m],), (lv[m] >> (8 * k)) & 0xFF,
                           accumulate=True)
    rec = wrap32(q[:, 0] | (q[:, 1] << 8) | (q[:, 2] << 16)
                  | (q[:, 3] << 24))
    recs = wrap32((rec & 0xFFFF) | (((rec >> 16) & 0x7FFF) << 16)) \
        .reshape(n_lanes, mb_count)
    return coeffs_T, recs, nfinal, dropped

