"""MPEG-1 host side without torch: ES segmentation and batch assembly.

SequenceInfo / PictureData records, the start-code scan, parse_es and
make_picture_batch (numpy), copied from espflix_tpu.models.mpeg1 and
pinned equal to it by tests/test_torch_host.py.  models/mpeg1.py
re-exports every name; the session feeds and the host worker pool
(runtime/hostpool.py) import them from here so that a process that only
segments and packs pictures never imports torch.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from espflix_tpu_torch.core import vlc_tables as V
from espflix_tpu_torch.core.bitio import BitReader


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
