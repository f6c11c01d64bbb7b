"""Batched MPEG-1 video decode: host segmentation + the dense phase.

Host side (numpy, models/mpeg1_host.py, re-exported here): start-code
scan, ES segmentation into PictureData records, and batch assembly.

Device side: ``dense_compose`` turns the scanner's dense buffers into
new frames in one pass over each MB row -- dequant+IDCT, prediction,
compose and put (ops/mocomp.idct_compose_put, K23);
``dense_compose_flat`` does the same from the lane-minor buffers in two
(K2F, K3F).  ``dense_compose_unfused``
is the mesh's form: prediction alone (K3P), then compose and put in
torch ops, with the 'space' split's band prediction.
``decode_picture_batch_sliced`` is the decode-only fleet's per-tick
decode on the slice scan (K1 or K1F) and one of the fused two;
``decode_picture_batch`` the device parser's: the sequential scan (K1S)
and ``dense_compose_flat``; ``decode_picture_batch_hybrid`` the hybrid
parser's: the native tokenizer (tools/oracle.py) on the host and
``dense_compose_flat``.  Frame state is double-buffered [N, 2, H, W]
planes plus a per-lane parity, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from espflix_tpu_torch.models.mpeg1_host import (  # noqa: F401
    PictureData, SequenceInfo, find_start_codes, make_picture_batch,
    parse_es)
from espflix_tpu_torch.ops import idct as idct_ops
from espflix_tpu_torch.ops import mocomp as mocomp_ops
from espflix_tpu_torch.ops import scan_dense as SD
from espflix_tpu_torch.ops import vlc_scan as VS


def init_frame_state(n_lanes: int, width: int, height: int,
                     device: torch.device | str):
    """Double-buffered planes + per-lane parity on `device`."""
    return dict(
        y=torch.zeros((n_lanes, 2, height, width), dtype=torch.uint8,
                      device=device),
        u=torch.zeros((n_lanes, 2, height // 2, width // 2),
                      dtype=torch.uint8, device=device),
        v=torch.zeros((n_lanes, 2, height // 2, width // 2),
                      dtype=torch.uint8, device=device),
        parity=torch.zeros((n_lanes,), dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# Dense phase
# ---------------------------------------------------------------------------

def dense_compose(coeffs_T, recs, nfinal, intra_q, non_intra_q, active,
                  frames, *, mb_width: int, mb_height: int,
                  scale_dct: torch.Tensor | None = None):
    """Dequant+IDCT, then prediction + compose + put, on the coeffs_T
    path of espflix_tpu.models.mpeg1.dense_compose: one pass over each
    MB row on the card (K23), K2's and K3's plain forms in turn on the
    CPU.

    coeffs_T int16[N, 64, MB*6]; recs int32[N, MB]; nfinal int32[N,
    MB*6]; intra_q/non_intra_q int32[N, 64]; active bool[N].  frames
    (y/u/v uint8[N, 2, H, W], parity int32[N]) is updated IN PLACE: the
    new picture is put into each live lane's parity slot (the reference
    slot 1-parity is only read) and a new parity tensor replaces
    frames["parity"].  Errored lanes keep their partial decode and still
    flip (the reference behaviour).  Returns (frames, presented) where
    presented y/u/v are new [N, H, W] tensors.
    """
    presented = mocomp_ops.idct_compose_put(
        coeffs_T, recs, nfinal, intra_q, non_intra_q, active, frames,
        mb_width=mb_width, mb_height=mb_height, scale_dct=scale_dct)
    parity = frames["parity"]
    frames["parity"] = torch.where(active, 1 - parity, parity)
    return frames, presented


def dense_compose_flat(coeffs, recs, nfinal, intra_q, non_intra_q, active,
                       frames, *, mb_width: int, mb_height: int,
                       scale_dct: torch.Tensor | None = None):
    """dense_compose on the lane-minor buffers (the coeffs_T is None
    branch of espflix_tpu.models.mpeg1.dense_compose, mpeg1.py:570-665):
    coeffs int16[N, MB*384] -> K2F residuals -> K3F prediction +
    compose + put.  Same in-place contract and returns as
    dense_compose."""
    res = idct_ops.block_residuals_flat(coeffs, recs, nfinal, intra_q,
                                        non_intra_q, scale_dct=scale_dct)
    presented = mocomp_ops.predict_compose_put_flat(
        res, recs, active, frames, mb_width=mb_width, mb_height=mb_height)
    parity = frames["parity"]
    frames["parity"] = torch.where(active, 1 - parity, parity)
    return frames, presented


def dense_compose_unfused(coeffs, recs, nfinal, intra_q, non_intra_q,
                          active, frames, *, mb_width: int, mb_height: int,
                          transposed: bool, ref_planes=None,
                          row0_mb: int = 0,
                          scale_dct: torch.Tensor | None = None):
    """The dense phase with prediction as its own pass: the branches of
    espflix_tpu.models.mpeg1.dense_compose that the mesh runs.

      * ref_planes None (use_pallas_mocomp=True, mpeg1.py:508-519): each
        plane predicted from the reference slot (K3P, rule A: two
        launches, y, then u and v together);
      * ref_planes = (y, u, v) full-height reference planes with row0_mb
        (the 'space' split, mpeg1.py:410-423): frames hold the band of
        MB rows [row0_mb, row0_mb + mb_height) and each plane is
        predicted from the full plane (K3P, rule B).

    Residuals come from coeffs_T int16[N, 64, MB*6] (transposed, K2) or
    lane-minor coeffs int16[N, MB*384] (K2F); compose and put run in
    torch ops (mpeg1.py:611-665).  Same in-place contract and returns as
    dense_compose."""
    if transposed:
        intra_bl, qs_bl = idct_ops.block_flags(recs)
        res = idct_ops.block_residuals_T(
            coeffs, intra_bl, qs_bl, intra_q, non_intra_q, nfinal,
            scale_dct=scale_dct)
        resid = mocomp_ops.residual_planes(res, mb_width, mb_height)
    else:
        res = idct_ops.block_residuals_flat(
            coeffs, recs, nfinal, intra_q, non_intra_q, scale_dct=scale_dct)
        resid = mocomp_ops.residual_planes_flat(res, mb_width, mb_height)
    _kind, mv_h, mv_v = mocomp_ops.mb_fields(recs, mb_width, mb_height)
    mvs = ((mv_h, mv_v), (mv_h >> 1, mv_v >> 1), (mv_h >> 1, mv_v >> 1))
    if ref_planes is None:
        lanes = torch.arange(recs.shape[0], device=recs.device)
        ref_slot = 1 - frames["parity"].long()
        preds = [mocomp_ops.predict_plane(frames["y"][lanes, ref_slot],
                                          mv_h, mv_v, 16),
                 *mocomp_ops.predict_chroma_pair(
                     frames["u"][lanes, ref_slot],
                     frames["v"][lanes, ref_slot], *mvs[1])]
    else:
        preds = [mocomp_ops.predict_plane_rows(rf, mh, mv, S, row0_mb)
                 for rf, (mh, mv), S in zip(ref_planes, mvs, (16, 8, 8))]
    presented = mocomp_ops.compose_put(
        preds, resid, recs, active, frames, mb_width=mb_width,
        mb_height=mb_height)
    parity = frames["parity"]
    frames["parity"] = torch.where(active, 1 - parity, parity)
    return frames, presented


def decode_picture_impl(words, slice_starts, slice_rows, n_slices,
                        pic_type, full_pel, r_size, intra_q, non_intra_q,
                        active, frames, *, mb_width: int, mb_height: int,
                        max_steps: int, slice_parallel: bool = False,
                        max_symbols: int = 20000,
                        tables: dict | None = None):
    """Decode one picture per lane on the device parser: the port of
    espflix_tpu.models.mpeg1.decode_picture_impl (mpeg1.py:260-320).
    slice_parallel=False runs the sequential scan (ops/vlc_scan.
    run_scan, K1S on a card); slice_parallel=True scans every slice as
    its own row (vlc_scan.scan_slices_cuda, K1S's per-slice pass alone,
    on a card; scan_slices_torch on the CPU), each (lane, slice) with
    the whole budget, into its lane's buffers.  Both then run the
    lane-minor dense phase (dense_compose_flat, K2F + K3F).

    Arguments are the make_picture_batch arrays as tensors on frames'
    device (xs_to_torch); tables: decode_tables(device), built when
    None.  Frames are updated in place.  Returns (frames, presented
    y/u/v, info) with info error / ok bool[N] and iters int32[N]: a lane
    errors on an FSM error or when its picture (sequential) or one of
    its slices (slice-parallel) is not scanned within min(max_steps,
    max_symbols) symbols; iters is the most steps any lane (sequential)
    or any slice (slice-parallel) took.  Pure lane-local: the mesh runs
    it per shard."""
    if tables is None:
        tables = decode_tables(frames["y"].device)
    N = words.shape[0]
    args = (words, slice_starts, slice_rows, n_slices, pic_type, full_pel,
            r_size)
    kw = dict(mb_width=mb_width, mb_height=mb_height, lut=tables["lut"],
              zigzag=tables["zigzag"])
    if slice_parallel:
        scan = (VS.scan_slices_torch if words.device.type == "cpu"
                else VS.scan_slices_cuda)
        coeffs, recs, nfinal, steps, end, _lo, _hi = scan(
            *args, budget=min(max_steps, max_symbols), **kw)
        err = (end != VS.END_CLEAN).any(dim=1)
        iters = steps.max()
    else:
        coeffs, recs, nfinal, err, iters = VS.run_scan(
            *args, max_steps=max_steps, max_symbols=max_symbols, **kw)
    frames, presented = dense_compose_flat(
        coeffs, recs, nfinal, intra_q, non_intra_q, active, frames,
        mb_width=mb_width, mb_height=mb_height,
        scale_dct=tables["scale_dct"])
    info = dict(error=err, ok=active & ~err, iters=iters.expand(N))
    return frames, presented, info


decode_picture_batch = decode_picture_impl

PICTURE_KEYS = ("words", "slice_starts", "slice_rows", "n_slices",
                "pic_type", "full_pel", "r_size", "intra_q", "non_intra_q",
                "active")


def decode_tables(device) -> dict:
    """The decode's constant tables on `device`: the scanner's unified
    VLC LUT, the zigzag order and the IDCT scale."""
    lut, _bases, _bits = VS._mega_lut_np()
    return dict(lut=torch.from_numpy(lut).to(device),
                zigzag=torch.from_numpy(VS.ZZ_NP).to(device),
                scale_dct=idct_ops.scale_dct_q(device))


def xs_to_torch(xs: dict, device) -> dict:
    """Host arrays (numpy) -> tensors on `device`; uint32 word buffers
    travel as int32 bit patterns."""
    out = {}
    for k, v in xs.items():
        a = np.asarray(v)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


def decode_es_batched(streams: list[bytes], words_per_lane=None,
                      max_steps=None, check_errors: bool = True, *,
                      slice_parallel: bool = False, device="cuda"):
    """Decode N elementary streams in lock-step; returns per-lane lists
    of numpy (y, u, v) frames: the port of espflix_tpu.models.mpeg1.
    decode_es_batched (mpeg1.py:970-1020), the validation and offline
    path.  Streams must share dimensions; a lane shorter than the
    longest is starved and presents nothing once its stream ends.

    One words_per_lane and slice count serve the whole run (the largest
    picture's, unless words_per_lane is given); the symbol budget is the
    batch's bit count (max_steps overrides it), so no picture is cut by
    a serving budget.  check_errors raises ValueError naming the picture
    and the active lanes in error.  Each picture runs decode_picture_impl
    on `device`: K1S, K2F and K3F on a card, their plain forms on the
    CPU.  slice_parallel (which the JAX function does not take) is
    passed through to it: the same decode with one scan row a slice."""
    parsed = [parse_es(s) for s in streams]
    seq = parsed[0][0]
    if any((sq.width, sq.height) != (seq.width, seq.height)
           for sq, _ in parsed):
        raise ValueError("streams of different dimensions")
    npics = max(len(p) for _, p in parsed)
    N = len(streams)
    mbw, mbh = seq.mb_width, seq.mb_height
    frames = init_frame_state(N, mbw * 16, mbh * 16, device)
    tables = decode_tables(frames["y"].device)
    outs = [[] for _ in range(N)]
    all_pics = [p for _, ps in parsed for p in ps]
    if words_per_lane is None:
        words_per_lane = max((len(p.payload) + 3) // 4 + 4
                             for p in all_pics)
    uniform_slices = max(
        max((len(p.slice_offsets) for p in all_pics), default=1), 1)
    for k in range(npics):
        batch_pics = [p[k] if k < len(p) else None for _, p in parsed]
        b = make_picture_batch(batch_pics, words_per_lane=words_per_lane,
                               max_slices=uniform_slices)
        ms = int(max_steps or b["words"].shape[1] * 32)
        x = xs_to_torch({key: b[key] for key in PICTURE_KEYS},
                        frames["y"].device)
        frames, presented, info = decode_picture_impl(
            *x.values(), frames, mb_width=b["mb_width"],
            mb_height=b["mb_height"], max_steps=ms, max_symbols=ms,
            slice_parallel=slice_parallel, tables=tables)
        if check_errors:
            bad = info["error"].cpu().numpy() & b["active"]
            if bad.any():
                raise ValueError(f"picture {k}: lane decode errors at "
                                 f"{np.nonzero(bad)[0]}")
        py, pu, pv = (presented[c].cpu().numpy() for c in "yuv")
        for i in range(N):
            if batch_pics[i] is not None:
                outs[i].append((py[i], pu[i], pv[i]))
    return outs


SCAN_KEYS = ("words", "start_bits", "rows", "alive", "pic_type",
             "full_pel", "r_size", "lane_of_row")


def _quantize_pow2(x: int, lo: int, hi: int) -> int:
    """Round x up to a power of two, clamped to [lo, hi] (mpeg1.py:705)."""
    p = lo
    while p < x and p < hi:
        p *= 2
    return min(max(p, lo), hi)


def decode_picture_batch_sliced(batch: dict, frames, *, mb_width: int,
                                mb_height: int, tables: dict,
                                max_steps: int = 2048,
                                steps_short: int = 512):
    """One tick's decode through the slice scan: the port of
    espflix_tpu.models.mpeg1.decode_picture_batch_sliced (mpeg1.py:
    714-807) with its default matmul scatter, on frames' device.

    Rows whose bit span exceeds steps_short count as long.  Small or
    mostly-long batches (need_long > NS - 8 or NS < 16, e.g. every
    one-lane fleet) take the uniform-budget scan over unsorted rows
    (K1F, max_steps in chunks of 256) and the lane-minor dense phase
    (K2F, K3F); the rest take the two-bucket dense scan (K1, long_rows
    = need_long rounded up to a power of two in [8, NS - 8], chunks of
    128) with duplicate slice claims flagged, then K2 and K3.  Lanes
    whose slice span overflows the word window are errors.

    tables: decode_tables(device).  frames are updated in place.
    Returns (frames, presented y/u/v, info) with info error / ok
    bool[N] and iters int32[N]."""
    dev = frames["y"].device
    n = len(batch["active"])
    lane = xs_to_torch({k: batch[k] for k in ("intra_q", "non_intra_q",
                                              "active")}, dev)
    scan_kw = dict(mb_width=mb_width, mb_height=mb_height, n_lanes=n,
                   lut=tables["lut"], zigzag=tables["zigzag"])
    sl = VS.pack_slice_rows(batch, sort_rows=True)
    NS = sl["span"].shape[0]
    need_long = int((sl["span"] * 32 > steps_short).sum())
    if need_long > NS - 8 or NS < 16:
        sl = VS.pack_slice_rows(batch)
        rows = xs_to_torch({k: sl[k] for k in SCAN_KEYS}, dev)
        coeffs, recs, nfinal, err, iters = VS.run_scan_bucketed(
            *rows.values(), long_rows=NS, steps_long=max_steps,
            steps_short=max_steps, chunk=256, **scan_kw)
        frames, presented = dense_compose_flat(
            coeffs, recs, nfinal, lane["intra_q"], lane["non_intra_q"],
            lane["active"], frames, mb_width=mb_width, mb_height=mb_height,
            scale_dct=tables["scale_dct"])
    else:
        long_rows = _quantize_pow2(max(need_long, 1), 8, max(NS - 8, 8))
        perm, dup = SD.row_perm(sl["lane_of_row"], sl["rows"],
                                sl["alive"], n, mb_height)
        rows = xs_to_torch(dict({k: sl[k] for k in SCAN_KEYS}, perm=perm),
                           dev)
        coeffs_T, recs, nfinal, err, iters = VS.run_scan_bucketed_dense(
            *rows.values(), long_rows=long_rows, steps_long=max_steps,
            steps_short=steps_short, chunk=128, **scan_kw)
        if dup.any():
            err = err | torch.from_numpy(dup).to(dev)
        frames, presented = dense_compose(
            coeffs_T, recs, nfinal, lane["intra_q"], lane["non_intra_q"],
            lane["active"], frames, mb_width=mb_width, mb_height=mb_height,
            scale_dct=tables["scale_dct"])
    if sl["overflow"].any():
        err = err | torch.from_numpy(sl["overflow"]).to(dev)
    info = dict(error=err, ok=lane["active"] & ~err,
                iters=iters.expand(n))
    return frames, presented, info


# ---------------------------------------------------------------------------
# The hybrid parser: the native tokenizer on the host, the dense phase on
# the device (espflix_tpu.models.mpeg1, mpeg1.py:811-968)
# ---------------------------------------------------------------------------

def tokenize_batch_native(pictures: list, mb_width: int, mb_height: int):
    """Entropy-decode one picture per lane with the native tokenizer
    (oracle/mpeg1_oracle.cpp mpeg1_tokenize_picture; tools/oracle.py).

    Returns numpy (coeffs int16[N, MB*384], recs int32[N, MB],
    nfinal int32[N, MB*6], active bool[N], errors bool[N])."""
    from espflix_tpu_torch.tools import oracle

    L = oracle.lib()
    N = len(pictures)
    mb_count = mb_width * mb_height
    coeffs = np.zeros((N, mb_count * 384), np.int16)
    recs = np.zeros((N, mb_count), np.int32)
    nfinal = np.zeros((N, mb_count * 6), np.uint8)
    active = np.zeros(N, bool)
    errors = np.zeros(N, bool)
    for i, p in enumerate(pictures):
        if p is None or not p.slice_offsets:
            continue
        active[i] = True
        offs = np.asarray(p.slice_offsets, np.int64)
        rows = np.asarray(p.slice_rows, np.int32)
        rc = L.mpeg1_tokenize_picture(
            p.payload, len(p.payload), offs.ctypes.data, rows.ctypes.data,
            len(offs), mb_width, mb_height, p.pic_type, p.full_pel,
            max(p.r_size, 0), coeffs[i].ctypes.data, recs[i].ctypes.data,
            nfinal[i].ctypes.data)
        errors[i] = rc != 0
    return coeffs, recs, nfinal.astype(np.int32), active, errors


DEFAULT_MAX_EMIT = 16384  # covers >5x the 1.5Mb/s I-frame symbol budget


def tokenize_batch_compact(pictures: list, mb_width: int, mb_height: int,
                           max_emit: int = DEFAULT_MAX_EMIT):
    """Compact native tokenize: coefficient emissions as packed
    (pos << 12 | level & 0xFFF) int32 words -- ~4x less host->device
    transfer than the dense buffer.  Returns numpy (emit int32[N,
    max_emit], n_emit int32[N], recs, nfinal, active, errors)."""
    from espflix_tpu_torch.tools import oracle

    L = oracle.lib()
    N = len(pictures)
    mb_count = mb_width * mb_height
    emit = np.zeros((N, max_emit), np.int32)
    n_emit = np.zeros(N, np.int32)
    recs = np.zeros((N, mb_count), np.int32)
    nfinal = np.zeros((N, mb_count * 6), np.uint8)
    active = np.zeros(N, bool)
    errors = np.zeros(N, bool)
    for i, p in enumerate(pictures):
        if p is None or not p.slice_offsets:
            continue
        active[i] = True
        offs = np.asarray(p.slice_offsets, np.int64)
        rows = np.asarray(p.slice_rows, np.int32)
        rc = L.mpeg1_tokenize_picture_compact(
            p.payload, len(p.payload), offs.ctypes.data, rows.ctypes.data,
            len(offs), mb_width, mb_height, p.pic_type, p.full_pel,
            max(p.r_size, 0), emit[i].ctypes.data, max_emit,
            recs[i].ctypes.data, nfinal[i].ctypes.data)
        if rc < 0:
            errors[i] = True
        else:
            n_emit[i] = rc
    return emit, n_emit, recs, nfinal.astype(np.int32), active, errors


def unpack_emissions(emit, n_emit, mb_count: int):
    """Packed emissions -> the lane-minor int16[N, MB*384] coefficient
    buffer (contiguous) with one scatter on emit's device.  Entries past
    a lane's n_emit land in a trash slot past the buffer; a well-formed
    stream writes no real slot twice."""
    N, E = emit.shape
    C = mb_count * 384
    dev = emit.device
    pos = (emit >> 12) & 0x1FFFF
    val = emit & 0xFFF
    val = torch.where(val >= 0x800, val - 0x1000, val)
    k = torch.arange(E, dtype=torch.int32, device=dev)[None, :]
    lane = torch.arange(N, dtype=torch.int64, device=dev)[:, None] * C
    flat = torch.where(k < n_emit[:, None], lane + pos, N * C)
    buf = torch.zeros(N * C + 1, dtype=torch.int16, device=dev)
    buf.scatter_(0, flat.reshape(-1), val.to(torch.int16).reshape(-1))
    return buf[:N * C].view(N, C)


def decode_picture_batch_hybrid(pictures: list, intra_q, non_intra_q,
                                frames, *, mb_width: int, mb_height: int,
                                compact: bool = True,
                                tables: dict | None = None):
    """The hybrid decode step: the native tokenizer on the host feeds
    the lane-minor dense phase (dense_compose_flat: K2F, K3F) on frames'
    device.  The tokenizer's buffers are the lane-minor layout the
    device parser's scan fills, so the dense phase is the one
    decode_picture_impl runs.  compact=True ships packed emissions and
    scatters them on the device (unpack_emissions); False ships the
    dense coefficient buffer.  intra_q / non_intra_q: int32[N, 64]
    (numpy).  Frames are updated in place.  Returns (frames, presented
    y/u/v, info) with info error / ok bool[N] and iters int32[N] (0)."""
    dev = frames["y"].device
    if tables is None:
        tables = decode_tables(dev)
    if compact:
        emit, n_emit, recs, nfinal, active, errors = \
            tokenize_batch_compact(pictures, mb_width, mb_height)
        x = xs_to_torch(dict(emit=emit, n_emit=n_emit), dev)
        coeffs = unpack_emissions(x["emit"], x["n_emit"],
                                  mb_width * mb_height)
    else:
        coeffs, recs, nfinal, active, errors = tokenize_batch_native(
            pictures, mb_width, mb_height)
        coeffs = torch.from_numpy(coeffs).to(dev)
    x = xs_to_torch(dict(recs=recs, nfinal=nfinal, intra_q=intra_q,
                         non_intra_q=non_intra_q, active=active,
                         errors=errors), dev)
    frames, presented = dense_compose_flat(
        coeffs, x["recs"], x["nfinal"], x["intra_q"], x["non_intra_q"],
        x["active"], frames, mb_width=mb_width, mb_height=mb_height,
        scale_dct=tables["scale_dct"])
    info = dict(error=x["errors"], ok=x["active"] & ~x["errors"],
                iters=torch.zeros(len(pictures), dtype=torch.int32,
                                  device=dev))
    return frames, presented, info
