"""Batched MPEG-1 video decode: host segmentation + the dense phase.

Host side (numpy, copied from espflix_tpu.models.mpeg1 and pinned equal
to it by tests/test_torch_host.py): start-code scan, ES segmentation
into PictureData records, and batch assembly.

Device side: ``dense_compose`` turns the scanner's dense buffers into
new frames -- dequant+IDCT (ops/idct.py, K2) and one fused prediction +
compose + put pass (ops/mocomp.py, K3); ``dense_compose_flat`` does the
same from the lane-minor buffers (K2F, K3F).
``decode_picture_batch_sliced`` is the decode-only fleet's per-tick
decode: the slice scan (K1 or K1F) and one of the two.  Frame state is
double-buffered [N, 2, H, W] planes plus a per-lane parity, as in the
JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from espflix_tpu_torch.core import vlc_tables as V
from espflix_tpu_torch.core.bitio import BitReader
from espflix_tpu_torch.ops import idct as idct_ops
from espflix_tpu_torch.ops import mocomp as mocomp_ops
from espflix_tpu_torch.ops import scan_dense as SD
from espflix_tpu_torch.ops import vlc_scan as VS
from espflix_tpu_torch.ops.vlc_scan import MB_INTRA


# ---------------------------------------------------------------------------
# Host-side ES segmentation
# ---------------------------------------------------------------------------

@dataclass
class SequenceInfo:
    width: int
    height: int
    intra_q: np.ndarray
    non_intra_q: np.ndarray

    @property
    def mb_width(self):
        return (self.width + 15) >> 4

    @property
    def mb_height(self):
        return (self.height + 15) >> 4


@dataclass
class PictureData:
    """One picture's payload, device-ready."""
    pic_type: int            # 1=I, 2=P (others are presented-but-skipped)
    full_pel: int
    r_size: int
    seq: SequenceInfo
    payload: bytes = b""     # slice region (start codes included)
    slice_offsets: list = field(default_factory=list)  # bit offsets
    slice_rows: list = field(default_factory=list)
    pts: int = -1


def find_start_codes(data: bytes):
    """All (byte_pos, code) of 00 00 01 xx prefixes, numpy-fast."""
    a = np.frombuffer(data, np.uint8)
    if len(a) < 4:
        return []
    hits = np.where((a[:-3] == 0) & (a[1:-2] == 0) & (a[2:-1] == 1))[0]
    return [(int(p), int(a[p + 3])) for p in hits]


def parse_es(data: bytes, pts_of=None) -> tuple[SequenceInfo, list]:
    """Segment an MPEG-1 video ES into PictureData records.

    Returns (sequence_info, pictures).  Non-I/P pictures produce records
    with no slices (lane presents/flips with unchanged content upstream).
    """
    codes = find_start_codes(data)
    seq: SequenceInfo | None = None
    pics: list[PictureData] = []
    cur: PictureData | None = None
    cur_start = None  # byte pos of first slice start code

    def close(end_byte):
        nonlocal cur, cur_start
        if cur is not None:
            if cur_start is not None:
                base = cur_start
                cur.payload = data[base:end_byte]
                cur.slice_offsets = [
                    (off - base) * 8 + 32 for off in cur.slice_offsets]
            cur = None
            cur_start = None

    npic = 0
    for pos, code in codes:
        if code == 0xB3:  # sequence header
            close(pos)
            r = BitReader(data[pos + 4:pos + 4 + 140])
            w, h = r.get(12), r.get(12)
            r.get(4 + 4 + 18 + 12)
            if r.get(1):
                iq = np.array([r.get(8) for _ in range(64)], np.int32)
            else:
                iq = V.DEFAULT_INTRA_Q.copy()
            if r.get(1):
                nq = np.array([r.get(8) for _ in range(64)], np.int32)
            else:
                nq = V.DEFAULT_NON_INTRA_Q.copy()
            seq = SequenceInfo(w, h, iq, nq)
        elif code == 0x00:  # picture
            close(pos)
            assert seq is not None, "picture before sequence header"
            r = BitReader(data[pos + 4:pos + 4 + 8])
            r.get(10)
            ptype = r.get(3)
            full_pel = r_size = 0
            if ptype == 2:
                r.get(16)
                full_pel = r.get(1)
                r_size = r.get(3) - 1
            pts = pts_of(npic) if pts_of else npic
            npic += 1
            cur = PictureData(ptype, full_pel, r_size, seq, pts=pts)
            pics.append(cur)
        elif 0x01 <= code <= 0xAF:  # slice
            if cur is not None and cur.pic_type in (1, 2):
                if cur_start is None:
                    cur_start = pos
                cur.slice_offsets.append(pos)
                cur.slice_rows.append(code - 1)
        elif code in (0xB7,):  # sequence end
            close(pos)
        # GOP (0xB8), user data, extensions: no action needed
    close(len(data))
    return seq, pics


# ---------------------------------------------------------------------------
# Batch assembly
# ---------------------------------------------------------------------------

def make_picture_batch(pictures: list, words_per_lane: int | None = None,
                       max_slices: int | None = None,
                       geometry: tuple | None = None):
    """Pack one PictureData per lane into host arrays.

    pictures may contain None entries (starved lane: no picture, lane
    keeps its frame and does not flip).  An ALL-None tick is legal when
    `geometry` (mb_width, mb_height) is given -- every lane masks out.
    """
    real = [p for p in pictures if p is not None]
    if real:
        seq = real[0].seq
        mbw_g, mbh = seq.mb_width, seq.mb_height
    else:
        assert geometry is not None and words_per_lane is not None, \
            "empty batch needs explicit geometry + words_per_lane"
        mbw_g, mbh = geometry
    S = max_slices or max(
        max((len(p.slice_offsets) for p in real), default=1), 1)
    if words_per_lane is None:
        words_per_lane = max(
            (len(p.payload) + 3) // 4 + 4 for p in real)

    N = len(pictures)
    words = np.zeros((N, words_per_lane), np.uint32)
    n_words = np.zeros(N, np.int32)
    slice_starts = np.zeros((N, S), np.int32)
    slice_rows = np.zeros((N, S), np.int32)
    n_slices = np.zeros(N, np.int32)
    pic_type = np.ones(N, np.int32)
    full_pel = np.zeros(N, np.int32)
    r_size = np.zeros(N, np.int32)
    intra_q = np.tile(V.DEFAULT_INTRA_Q, (N, 1)).astype(np.int32)
    non_intra_q = np.tile(V.DEFAULT_NON_INTRA_Q, (N, 1)).astype(np.int32)
    active = np.zeros(N, bool)

    # raw payload bytes land directly in the words buffer, then ONE
    # in-place byteswap over the used prefix gives big-endian words
    u8 = words.view(np.uint8).reshape(N, words_per_lane * 4)
    EOS = BitReader.EOS  # 00 00 01 B7 x2
    maxw = 0
    for i, p in enumerate(pictures):
        if p is None:
            continue
        pl = p.payload
        n = len(pl)
        pad = (-n) % 4
        nw = (n + pad) // 4 + 4     # payload + 2x EOS pad (8B pattern)
        assert nw <= words_per_lane, (nw, words_per_lane)
        u8[i, :n] = np.frombuffer(pl, np.uint8)
        u8[i, n:n + pad + 16] = np.frombuffer(
            EOS[:pad] + EOS * 2, np.uint8)
        n_words[i] = nw
        maxw = max(maxw, nw)
        k = len(p.slice_offsets)
        assert k <= S
        slice_starts[i, :k] = p.slice_offsets
        slice_rows[i, :k] = p.slice_rows
        n_slices[i] = k
        pic_type[i] = p.pic_type
        full_pel[i] = p.full_pel
        r_size[i] = max(p.r_size, 0)
        intra_q[i] = p.seq.intra_q
        non_intra_q[i] = p.seq.non_intra_q
        active[i] = True
    if maxw:
        words[:, :maxw].byteswap(inplace=True)

    return dict(
        words=words, slice_starts=slice_starts, slice_rows=slice_rows,
        n_slices=n_slices, pic_type=pic_type, full_pel=full_pel,
        r_size=r_size, intra_q=intra_q, non_intra_q=non_intra_q,
        active=active, n_words=n_words,
        mb_width=mbw_g, mb_height=mbh,
    )


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
    path of espflix_tpu.models.mpeg1.dense_compose.

    coeffs_T int16[N, 64, MB*6]; recs int32[N, MB]; nfinal int32[N,
    MB*6]; intra_q/non_intra_q int32[N, 64]; active bool[N].  frames
    (y/u/v uint8[N, 2, H, W], parity int32[N]) is updated IN PLACE: the
    new picture is put into each live lane's parity slot (the reference
    slot 1-parity is only read) and a new parity tensor replaces
    frames["parity"].  Errored lanes keep their partial decode and still
    flip (the reference behaviour).  Returns (frames, presented) where
    presented y/u/v are new [N, H, W] tensors.
    """
    intra_bl = ((recs & 3) == MB_INTRA).repeat_interleave(6, dim=1)
    qs_bl = ((recs >> 2) & 31).repeat_interleave(6, dim=1)
    res_T = idct_ops.block_residuals_T(
        coeffs_T, intra_bl, qs_bl, intra_q, non_intra_q, nfinal,
        scale_dct=scale_dct)
    presented = mocomp_ops.predict_compose_put(
        res_T, recs, active, frames, mb_width=mb_width,
        mb_height=mb_height)
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
