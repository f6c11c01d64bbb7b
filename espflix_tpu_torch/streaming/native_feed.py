"""Native per-lane session feed: ctypes facade over
native/session_feed.cpp.

Ported from espflix_tpu/streaming/native_feed.py over the same
native/libespflix_native.so (built by streaming/native.py with `make`
in native/).  The port keeps its own FeedPool, handles and scratch, so
one process can run the port and the JAX package side by side; its
pictures are the port's models/mpeg1.PictureData (defined in the
torch-free models/mpeg1_host.py, so a host worker never imports torch).

Drop-in replacement for runtime/session.py's StreamFeed (same
surface: feed/eos/pop_picture/sync_lost + an `audio` ring with
discover/pop_frames/pop_frames_array).  All per-lane demux and
ES-segmentation state lives in C++; Python only marshals complete
pictures.  The reference dedicates a CPU core to this pump
(src/espflix.cpp:723-737, player.cpp:459-493); the JAX package
measured its pure-Python path at ~120 ms/tick for 1k lanes on one host
core, dominated by per-lane ctypes demux marshalling and numpy
start-code scans -- exactly the byte-bashing that belongs in native
code.

Bit-identity with the Python path and with the JAX package's native
feed is pinned by tests/test_torch_native_feed.py.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from espflix_tpu_torch.core import vlc_tables as V
from espflix_tpu_torch.models.mpeg1_host import PictureData, SequenceInfo
from espflix_tpu_torch.streaming import native as NT

# meta layout (session_feed.cpp enum)
M_PTYPE, M_FULL_PEL, M_R_SIZE, M_PTS, M_PAYLOAD_LEN, M_NSLICES, \
    M_SEQ_COUNTER, M_WIDTH, M_HEIGHT, M_HAS_IQ, M_HAS_NQ, \
    M_SYNC_LOST = range(12)
M_COUNT = 12

_configured = False


def lib():
    global _configured
    L = NT.lib()
    if L is None:
        return None
    if not _configured:
        _configured = True
        c = ctypes
        L.sf_create.restype = c.c_void_p
        L.sf_create.argtypes = [c.c_int]
        L.sf_destroy.argtypes = [c.c_void_p]
        L.sf_reset.argtypes = [c.c_void_p, c.c_int]
        L.sf_feed.restype = c.c_int
        L.sf_feed.argtypes = [c.c_void_p, c.c_int, c.c_char_p, c.c_long]
        L.sf_eos.argtypes = [c.c_void_p, c.c_int]
        L.sf_pop_picture.restype = c.c_int
        L.sf_pop_picture.argtypes = [
            c.c_void_p, c.c_int, c.c_void_p, c.c_void_p, c.c_long,
            c.c_void_p, c.c_void_p, c.c_int, c.c_void_p, c.c_void_p]
        L.sf_feed_many.restype = c.c_int
        L.sf_feed_many.argtypes = [
            c.c_void_p, c.c_void_p, c.c_int, c.c_char_p, c.c_void_p]
        L.sf_pop_pictures.restype = c.c_int
        L.sf_pop_pictures.argtypes = [
            c.c_void_p, c.c_void_p, c.c_int, c.c_void_p, c.c_void_p,
            c.c_long, c.c_void_p, c.c_void_p, c.c_void_p, c.c_int,
            c.c_void_p, c.c_void_p, c.c_void_p]
        L.sf_pop_pictures_packed.restype = c.c_int
        L.sf_pop_pictures_packed.argtypes = [
            c.c_void_p, c.c_void_p, c.c_int, c.c_void_p, c.c_void_p,
            c.c_void_p, c.c_long, c.c_void_p, c.c_void_p, c.c_void_p,
            c.c_void_p, c.c_int, c.c_void_p, c.c_void_p, c.c_void_p]
        L.sf_audio_len.restype = c.c_long
        L.sf_audio_len.argtypes = [c.c_void_p, c.c_int]
        L.sf_audio_pts.restype = c.c_longlong
        L.sf_audio_pts.argtypes = [c.c_void_p, c.c_int]
        L.sf_audio_peek.restype = c.c_long
        L.sf_audio_peek.argtypes = [c.c_void_p, c.c_int, c.c_void_p,
                                    c.c_long]
        L.sf_audio_pop.restype = c.c_int
        L.sf_audio_pop.argtypes = [c.c_void_p, c.c_int, c.c_int,
                                   c.c_int, c.c_void_p]
        L.sf_audio_clear.argtypes = [c.c_void_p, c.c_int]
        L.sf_audio_pop_batch.restype = None
        L.sf_audio_pop_batch.argtypes = [
            c.c_void_p, c.c_void_p, c.c_int, c.c_void_p, c.c_void_p,
            c.c_int, c.c_int, c.c_void_p, c.c_void_p]
        L.sf_audio_poke.argtypes = [c.c_void_p, c.c_int, c.c_long,
                                    c.c_int]
        L.sf_sync_lost.restype = c.c_int
        L.sf_sync_lost.argtypes = [c.c_void_p, c.c_int]
    return L


def available() -> bool:
    return lib() is not None


class FeedPool:
    """One native Feed handle shared by every NativeStreamFeed in the
    process; lanes recycle through a free list (a PlayerSession makes
    a fresh feed per play())."""

    def __init__(self, capacity: int):
        self.L = lib()
        assert self.L is not None
        self.capacity = capacity
        self.handle = self.L.sf_create(capacity)
        self._free = list(range(capacity - 1, -1, -1))

    def acquire(self) -> int:
        lane = self._free.pop()      # IndexError = pool exhausted
        self.L.sf_reset(self.handle, lane)
        return lane

    def release(self, lane: int):
        self._free.append(lane)


_pool: FeedPool | None = None


def get_pool() -> FeedPool:
    global _pool
    if _pool is None:
        _pool = FeedPool(int(os.environ.get("ESPFLIX_FEED_LANES",
                                            "4096")))
    return _pool


# scratch (module-level; single-threaded pump like the Python path).
# Raw .ctypes.data ints are cached -- ctypes' data_as()/cast() per
# call was ~40% of pop_picture in the 1k-lane host profile.
_PAYLOAD_CAP = 1 << 20
_MAX_SLICES = 1024
_meta = np.zeros(M_COUNT, np.int64)
_payload = np.zeros(_PAYLOAD_CAP, np.uint8)
_slice_off = np.zeros(_MAX_SLICES, np.int32)
_slice_rows = np.zeros(_MAX_SLICES, np.int32)
_iq = np.zeros(64, np.uint8)
_nq = np.zeros(64, np.uint8)
_ptrs = ()


def _cache_ptrs():
    global _ptrs
    _ptrs = (_meta.ctypes.data, _payload.ctypes.data,
             _slice_off.ctypes.data, _slice_rows.ctypes.data,
             _iq.ctypes.data, _nq.ctypes.data)


_cache_ptrs()


def _grow(rc):
    global _PAYLOAD_CAP, _MAX_SLICES, _payload, _slice_off, _slice_rows
    if rc == -2:
        _PAYLOAD_CAP *= 2
        _payload = np.zeros(_PAYLOAD_CAP, np.uint8)
    else:
        _MAX_SLICES *= 2
        _slice_off = np.zeros(_MAX_SLICES, np.int32)
        _slice_rows = np.zeros(_MAX_SLICES, np.int32)
    _cache_ptrs()


class NativeAudioRing:
    """SbcRing facade (runtime/session.py): bytes live in C++."""

    def __init__(self, pool: FeedPool, lane: int):
        self._p = pool
        self._lane = lane
        self.frame_size = 0
        self.channels = 1
        self.blocks = 16

    @property
    def pts(self) -> int:
        return int(self._p.L.sf_audio_pts(self._p.handle, self._lane))

    def discover(self, probe) -> int:
        if not self.frame_size and \
                self._p.L.sf_audio_len(self._p.handle, self._lane) >= 64:
            buf = np.zeros(512, np.uint8)
            n = self._p.L.sf_audio_peek(
                self._p.handle, self._lane,
                buf.ctypes.data_as(ctypes.c_void_p), 512)
            r = probe(buf[:n].tobytes())
            ch, bl = 1, 16
            if isinstance(r, tuple):
                r, ch, bl = r
            if r and r > 0:
                self.frame_size = r
                self.channels = ch
                self.blocks = bl
        return self.frame_size

    def pop_frames_array(self, max_frames: int):
        fs = self.frame_size
        if not fs:
            return None
        out = np.empty((max_frames, fs), np.uint8)
        k = self._p.L.sf_audio_pop(
            self._p.handle, self._lane, fs, max_frames,
            out.ctypes.data_as(ctypes.c_void_p))
        if k == 0:
            return None
        return out[:k]

    def pop_frames(self, max_frames: int) -> list[bytes]:
        fa = self.pop_frames_array(max_frames)
        if fa is None:
            return []
        return [fa[i].tobytes() for i in range(fa.shape[0])]

    def clear(self):
        self._p.L.sf_audio_clear(self._p.handle, self._lane)

    def size(self) -> int:
        return int(self._p.L.sf_audio_len(self._p.handle, self._lane))

    def poke(self, off: int, value: int):
        """Overwrite one buffered byte (fault injection)."""
        self._p.L.sf_audio_poke(self._p.handle, self._lane, off, value)


# batched-pop scratch (grown on demand)
_B = dict(n=0)


def _batch_scratch(n):
    if _B["n"] < n:
        _B["n"] = max(n, 256)
        _B["meta"] = np.zeros((_B["n"], M_COUNT), np.int64)
        _B["off"] = np.zeros(_B["n"], np.int64)
        _B["rc"] = np.zeros(_B["n"], np.int32)
        _B["lanes"] = np.zeros(_B["n"], np.int32)
        _B["iq"] = np.zeros((_B["n"], 64), np.uint8)
        _B["nq"] = np.zeros((_B["n"], 64), np.uint8)
        _B.pop("so", None)
        _B.pop("arena", None)
    if "so" not in _B or _B["so"].shape[1] < _MAX_SLICES:
        _B["so"] = np.zeros((_B["n"], _MAX_SLICES), np.int32)
        _B["sr"] = np.zeros((_B["n"], _MAX_SLICES), np.int32)
    if "arena" not in _B:
        _B["arena"] = np.zeros(32 << 20, np.uint8)
    return _B


def pop_many(feeds):
    """Batched pop_picture over NativeStreamFeeds sharing one pool:
    ONE ctypes call for the whole fleet (sf_pop_pictures) instead of
    per-lane calls.  Returns a list[PictureData | None] aligned with
    `feeds`.  Lanes whose output overflowed the shared scratch are
    retried alone (their pop was not consumed), so a partial overflow
    never double-pops a lane."""
    n = len(feeds)
    if n == 0:
        return []
    pool = feeds[0]._pool
    B = _batch_scratch(n)
    B["lanes"][:n] = [f._lane for f in feeds]
    L = pool.L
    L.sf_pop_pictures(
        pool.handle, B["lanes"].ctypes.data, n,
        B["meta"].ctypes.data, B["arena"].ctypes.data,
        len(B["arena"]), B["off"].ctypes.data, B["so"].ctypes.data,
        B["sr"].ctypes.data, B["so"].shape[1], B["iq"].ctypes.data,
        B["nq"].ctypes.data, B["rc"].ctypes.data)
    out = [None] * n
    meta, off, rc = B["meta"], B["off"], B["rc"]
    for k in range(n):
        r = int(rc[k])
        if r == 0:
            continue
        if r < 0:
            # grow (module scratch: also raises the per-lane caps the
            # single-pop path uses) and retry this lane alone
            _grow(r)
            out[k] = feeds[k].pop_picture()
            continue
        f = feeds[k]
        m = meta[k]
        assert m[M_WIDTH] > 0, "picture before sequence header"
        if int(m[M_SEQ_COUNTER]) != f._seq_counter:
            iq = B["iq"][k].astype(np.int32) if m[M_HAS_IQ] \
                else V.DEFAULT_INTRA_Q.copy()
            nq = B["nq"][k].astype(np.int32) if m[M_HAS_NQ] \
                else V.DEFAULT_NON_INTRA_Q.copy()
            f._seq = SequenceInfo(int(m[M_WIDTH]), int(m[M_HEIGHT]),
                                  iq, nq)
            f._seq_counter = int(m[M_SEQ_COUNTER])
        pic = PictureData(int(m[M_PTYPE]), int(m[M_FULL_PEL]),
                          int(m[M_R_SIZE]), f._seq,
                          pts=int(m[M_PTS]))
        plen = int(m[M_PAYLOAD_LEN])
        if plen:
            o = int(off[k])
            pic.payload = B["arena"][o:o + plen].tobytes()
            nsl = int(m[M_NSLICES])
            pic.slice_offsets = B["so"][k, :nsl].tolist()
            pic.slice_rows = B["sr"][k, :nsl].tolist()
        out[k] = pic
    return out


def feed_many(feeds, datas):
    """Batched feed: ONE sf_feed_many call pushes each feed's chunk
    (the pump's streamer.read result) into its native lane.  All
    feeds share one pool; empty chunks must be filtered by the caller
    (EOS is a per-lane state change, not a feed)."""
    n = len(feeds)
    if n == 0:
        return
    pool = feeds[0]._pool
    lanes = np.fromiter((f._lane for f in feeds), np.int32, n)
    offs = np.zeros(n + 1, np.int64)
    for k, d in enumerate(datas):
        offs[k + 1] = offs[k] + len(d)
    buf = b"".join(datas)
    pool.L.sf_feed_many(pool.handle, lanes.ctypes.data, n, buf,
                        offs.ctypes.data)


def pop_audio_many(rings, slots, max_frames, out):
    """Batched SBC ring drain: ONE sf_audio_pop_batch call pops up to
    max_frames whole frames per ring straight into the tick's arena
    rows out[slots[i]] (a zeroed [n_lanes, max_frames, stride] uint8;
    each ring's frames land at byte stride out.shape[2]).  All rings
    must share one FeedPool.  Returns counts int32[len(rings)]."""
    n = len(rings)
    if n == 0:
        return np.zeros(0, np.int32)
    pool = rings[0]._p
    lanes = np.fromiter((r._lane for r in rings), np.int32, n)
    fss = np.fromiter((r.frame_size for r in rings), np.int32, n)
    rows = np.asarray(slots, np.int32)
    counts = np.zeros(n, np.int32)
    assert out.flags.c_contiguous and out.dtype == np.uint8
    pool.L.sf_audio_pop_batch(
        pool.handle, lanes.ctypes.data, n, fss.ctypes.data,
        rows.ctypes.data, max_frames, out.shape[2],
        out.ctypes.data, counts.ctypes.data)
    return counts


class PackedBatch:
    """Persistent device-batch-layout buffers one Fleet owns.

    Popped pictures land straight in `words` (payload + EOS pad +
    big-endian byteswap done in C++, sf_pop_pictures_packed) so no
    PictureData object, payload bytes() copy, or per-lane numpy word
    packing exists on the hot path.  Rows are kept bit-identical to a
    freshly zeroed make_picture_batch row: the native side zeroes each
    row's stale region above the new payload (prev_nw high-water).
    """

    def __init__(self, n: int, words_per_lane: int, max_slices: int,
                 mb_width: int, mb_height: int):
        self.n = n
        self.words_per_lane = words_per_lane
        self.max_slices = max_slices
        self.mb_width, self.mb_height = mb_width, mb_height
        self.words = np.zeros((n, words_per_lane), np.uint32)
        self.words_u8 = self.words.view(np.uint8).reshape(
            n, words_per_lane * 4)
        self.prev_nw = np.zeros(n, np.int32)
        self.n_words = np.zeros(n, np.int32)
        self.slice_starts = np.zeros((n, max_slices), np.int32)
        self.slice_rows = np.zeros((n, max_slices), np.int32)
        self.n_slices = np.zeros(n, np.int32)
        self.pic_type = np.ones(n, np.int32)
        self.full_pel = np.zeros(n, np.int32)
        self.r_size = np.zeros(n, np.int32)
        self.intra_q = np.tile(V.DEFAULT_INTRA_Q, (n, 1)) \
            .astype(np.int32)
        self.non_intra_q = np.tile(V.DEFAULT_NON_INTRA_Q, (n, 1)) \
            .astype(np.int32)
        self.active = np.zeros(n, bool)
        self.pts = np.full(n, -1, np.int64)
        # per-slot (source, seq_counter) key for the q-table rows; the
        # source object (feed or SequenceInfo) is held so identity
        # can't be recycled while the key is live
        self.seq_src: list = [None] * n
        # vectorized twin of seq_src for the numpy happy path:
        # (native_lane << 44) | seq_counter -- collision-free because
        # seq_counter is monotonic per native lane across resets
        # (session_feed.cpp Lane::reset), or -1 = always stale
        self.qkey = np.full(n, -1, np.int64)
        self._slots = np.zeros(n, np.int32)

    def begin_tick(self):
        """Reset the per-lane meta vectors to the classic batch's
        inactive-lane values (a stale n_slices would mark dead scan
        rows alive; a stale n_words would inflate the device window).
        words rows and prev_nw persist -- the native side zeroes each
        row's stale region on the next pop."""
        self.active[:] = False
        self.pts[:] = -1
        self.n_slices[:] = 0
        self.n_words[:] = 0
        self.pic_type[:] = 1
        self.full_pel[:] = 0
        self.r_size[:] = 0

    def batch_dict(self) -> dict:
        """make_picture_batch-compatible view.  words/slice arrays are
        the persistent buffers (consumers copy: pack_slice_rows gathers
        or trims); the small per-lane vectors are copied so a chunked
        caller can stack several ticks."""
        return dict(
            words=self.words, slice_starts=self.slice_starts,
            slice_rows=self.slice_rows, n_slices=self.n_slices.copy(),
            pic_type=self.pic_type.copy(),
            full_pel=self.full_pel.copy(), r_size=self.r_size.copy(),
            intra_q=self.intra_q.copy(),
            non_intra_q=self.non_intra_q.copy(),
            active=self.active.copy(), n_words=self.n_words.copy(),
            mb_width=self.mb_width, mb_height=self.mb_height)

    def set_queues(self, slot: int, src, has_iq: bool, has_nq: bool,
                   iq8, nq8, counter: int, qkey: int = -1):
        """Refresh the q-table rows when (src, counter) changed."""
        key = (src, counter)
        cur = self.seq_src[slot]
        self.qkey[slot] = qkey
        if cur is not None and cur[0] is src and cur[1] == counter:
            return
        self.seq_src[slot] = key
        self.intra_q[slot] = np.asarray(iq8, np.int32) if has_iq \
            else V.DEFAULT_INTRA_Q
        self.non_intra_q[slot] = np.asarray(nq8, np.int32) if has_nq \
            else V.DEFAULT_NON_INTRA_Q

    def merge_picture(self, slot: int, pic) -> None:
        """Classic-path merge for a lane the packed pop didn't cover
        (non-native feed, overridden next_picture, capacity retry).
        Mirrors make_picture_batch's per-lane body exactly."""
        pl = pic.payload
        n = len(pl)
        pad = (-n) % 4
        nw = (n + pad) // 4 + 4
        assert nw <= self.words_per_lane, (nw, self.words_per_lane)
        u8 = self.words_u8[slot]
        u8[:n] = np.frombuffer(pl, np.uint8)
        EOS = _EOS8
        u8[n:n + pad + 16] = np.frombuffer(EOS[:pad] + EOS * 2,
                                           np.uint8)
        self.words[slot, :nw].byteswap(inplace=True)
        hw = int(self.prev_nw[slot])
        if hw > nw:
            self.words[slot, nw:hw] = 0
        self.prev_nw[slot] = nw
        self.n_words[slot] = nw
        k = len(pic.slice_offsets)
        assert k <= self.max_slices
        self.slice_starts[slot, :k] = pic.slice_offsets
        self.slice_rows[slot, :k] = pic.slice_rows
        self.n_slices[slot] = k
        self.pic_type[slot] = pic.pic_type
        self.full_pel[slot] = pic.full_pel
        self.r_size[slot] = max(pic.r_size, 0)
        self.set_queues(slot, pic.seq, True, True, pic.seq.intra_q,
                        pic.seq.non_intra_q, 0)
        self.active[slot] = True
        self.pts[slot] = pic.pts


_EOS8 = bytes([0x00, 0x00, 0x01, 0xB7]) * 2  # == BitReader.EOS


def pop_many_packed(pb: PackedBatch, feeds, slots):
    """One packed pop round: each feed's next complete picture lands
    directly in pb's batch buffers at its fleet slot.  Returns
    (rc [n], meta [n, M_COUNT], iq8 [n, 64], nq8 [n, 64]) scratch
    views valid until the next pop_many/pop_many_packed call.
    rc: 1 picture (row updated), 0 none, <0 capacity (NOT consumed --
    resolve that lane via pop_picture + PackedBatch.merge_picture)."""
    n = len(feeds)
    pool = feeds[0]._pool
    B = _batch_scratch(n)
    B["lanes"][:n] = [f._lane for f in feeds]
    sl = pb._slots
    sl[:n] = slots
    pool.L.sf_pop_pictures_packed(
        pool.handle, B["lanes"].ctypes.data, n, sl.ctypes.data,
        B["meta"].ctypes.data, pb.words.ctypes.data,
        pb.words_per_lane, pb.prev_nw.ctypes.data,
        pb.n_words.ctypes.data, pb.slice_starts.ctypes.data,
        pb.slice_rows.ctypes.data, pb.max_slices,
        B["iq"].ctypes.data, B["nq"].ctypes.data,
        B["rc"].ctypes.data)
    return B["rc"][:n], B["meta"][:n], B["iq"][:n], B["nq"][:n]


class NativeStreamFeed:
    """StreamFeed-compatible facade over one native lane."""

    def __init__(self):
        self._pool = get_pool()
        self._lane = self._pool.acquire()
        self.audio = NativeAudioRing(self._pool, self._lane)
        self._seq_counter = -1
        self._seq: SequenceInfo | None = None

    def __del__(self):
        lane, self._lane = self._lane, None
        if lane is not None and self._pool is not None:
            self._pool.release(lane)

    def feed(self, data: bytes):
        self._pool.L.sf_feed(self._pool.handle, self._lane, data,
                             len(data))

    def eos(self):
        self._pool.L.sf_eos(self._pool.handle, self._lane)

    @property
    def sync_lost(self) -> bool:
        return bool(self._pool.L.sf_sync_lost(self._pool.handle,
                                              self._lane))

    def _build_seq(self) -> SequenceInfo:
        iq = _iq.astype(np.int32) if _meta[M_HAS_IQ] \
            else V.DEFAULT_INTRA_Q.copy()
        nq = _nq.astype(np.int32) if _meta[M_HAS_NQ] \
            else V.DEFAULT_NON_INTRA_Q.copy()
        return SequenceInfo(int(_meta[M_WIDTH]), int(_meta[M_HEIGHT]),
                            iq, nq)

    def pop_picture(self) -> PictureData | None:
        while True:
            mp, pp, sop, srp, iqp, nqp = _ptrs
            rc = self._pool.L.sf_pop_picture(
                self._pool.handle, self._lane, mp, pp, _PAYLOAD_CAP,
                sop, srp, _MAX_SLICES, iqp, nqp)
            if rc >= 0:
                break
            _grow(rc)
        if rc == 0:
            return None
        assert _meta[M_WIDTH] > 0, "picture before sequence header"
        if int(_meta[M_SEQ_COUNTER]) != self._seq_counter:
            self._seq = self._build_seq()
            self._seq_counter = int(_meta[M_SEQ_COUNTER])
        pic = PictureData(int(_meta[M_PTYPE]), int(_meta[M_FULL_PEL]),
                          int(_meta[M_R_SIZE]), self._seq,
                          pts=int(_meta[M_PTS]))
        plen = int(_meta[M_PAYLOAD_LEN])
        nsl = int(_meta[M_NSLICES])
        if plen:
            pic.payload = _payload[:plen].tobytes()
            pic.slice_offsets = _slice_off[:nsl].tolist()
            pic.slice_rows = _slice_rows[:nsl].tolist()
        return pic
