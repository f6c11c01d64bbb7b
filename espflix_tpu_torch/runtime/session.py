"""Per-stream feed: incremental TS -> picture payloads + SBC audio.

Copied from espflix_tpu.runtime.session (session.py:28-299), which
imports the JAX package's models.mpeg1; here the pictures are the
port's models/mpeg1.PictureData (defined in the torch-free
models/mpeg1_host.py, so a host worker that runs sessions never imports
torch).  tests/test_torch_serve.py pins the copy to the original.

The host-side analogue of the reference's buffer pump + pull-model
demux (the reference src/espflix.cpp:723-737, player.cpp:459-493):
bytes arrive in bounded reads from a Streamer, the transport stream is
demuxed incrementally, and complete picture payloads (with their
sequence context and PTS) are handed to the batched device decoder.
Backpressure is the bounded `max_buffered_pictures` (the analogue of
the reference's 4-buffer pool).
"""

from __future__ import annotations

import os
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from espflix_tpu_torch.core.bitio import BitReader
from espflix_tpu_torch.core import vlc_tables as V
from espflix_tpu_torch.streaming import native as NT
from espflix_tpu_torch.streaming.ts import TS_PACKET
from espflix_tpu_torch.models.mpeg1_host import PictureData, SequenceInfo


@dataclass
class EsSegmenter:
    """Incremental ES -> complete picture chunks with sequence context.

    Start codes are scanned INCREMENTALLY (only bytes that arrived
    since the last scan; found codes are cached and rebased when the
    buffer head is consumed) -- the naive rescan made pop_picture
    O(buffer^2) per session and dominated the 1k-lane host profile.
    """
    seq: SequenceInfo | None = None
    _buf: bytearray = field(default_factory=bytearray)
    _pts_marks: deque = field(default_factory=deque)  # (offset, pts)
    _base: int = 0      # absolute offset of _buf[0]
    _eos: bool = False
    _last_pts: int = -1
    _scanned: int = 0
    _code_list: list = field(default_factory=list)
    _seq_parsed_abs: int = -1

    def push(self, data: bytes):
        self._buf += data

    def mark_pts(self, pts: int):
        self._pts_marks.append((self._base + len(self._buf), pts))

    def eos(self):
        self._eos = True

    def _codes(self):
        n = len(self._buf)
        if n >= 4 and n > self._scanned:
            a = np.frombuffer(self._buf, np.uint8)
            start = max(self._scanned - 3, 0)
            seg = a[start:]
            hits = np.where((seg[:-3] == 0) & (seg[1:-2] == 0)
                            & (seg[2:-1] == 1))[0]
            if len(hits):
                self._code_list.extend(
                    (int(p) + start, int(seg[p + 3])) for p in hits)
            self._scanned = n
        return self._code_list

    def _consume(self, end: int):
        del self._buf[:end]
        self._base += end
        self._scanned = max(self._scanned - end, 0)
        self._code_list = [(p - end, c) for p, c in self._code_list
                           if p >= end]

    def _seq_ready(self, pos: int) -> bool:
        """All bytes of the sequence header at `pos` have arrived.
        BitReader pads past the end with the EOS pattern, so parsing a
        header split across feed chunks would cache garbage geometry;
        defer until the (load-flag-dependent) length is buffered."""
        if self._eos:
            return True
        b = self._buf
        avail = len(b) - (pos + 4)
        if avail < 8:
            return False
        load_iq = (b[pos + 4 + 7] >> 1) & 1   # bit 62
        if not load_iq:
            load_nq = b[pos + 4 + 7] & 1      # bit 63
            return not load_nq or avail >= 72
        if avail < 72:
            return False
        load_nq = b[pos + 4 + 71] & 1         # bit 575
        return not load_nq or avail >= 136

    def _parse_seq(self, pos: int):
        r = BitReader(bytes(self._buf[pos + 4:pos + 4 + 140]))
        w, h = r.get(12), r.get(12)
        r.get(4 + 4 + 18 + 12)
        iq = np.array([r.get(8) for _ in range(64)], np.int32) \
            if r.get(1) else V.DEFAULT_INTRA_Q.copy()
        nq = np.array([r.get(8) for _ in range(64)], np.int32) \
            if r.get(1) else V.DEFAULT_NON_INTRA_Q.copy()
        self.seq = SequenceInfo(w, h, iq, nq)

    def pop_picture(self) -> PictureData | None:
        """Extract the next complete picture chunk, or None."""
        codes = self._codes()
        pend = None
        pic_start = None
        pic_pos = None
        for pos, code in codes:
            if code in (0xB3, 0xB8, 0xB2, 0xB5):
                if pic_pos is not None:   # next chunk begins
                    return self._emit(pic_start, pend if pend is not None
                                      else pos, pic_pos)
                if pend is None:
                    pend = pos
                if code == 0xB3 and \
                        self._base + pos != self._seq_parsed_abs and \
                        self._seq_ready(pos):
                    # parse each sequence header once (pop_picture can
                    # walk over a buffered header many times)
                    self._parse_seq(pos)
                    self._seq_parsed_abs = self._base + pos
            elif code == 0x00:
                if pic_pos is not None:
                    return self._emit(pic_start,
                                      pend if pend is not None else pos,
                                      pic_pos)
                pic_start = pend if pend is not None else pos
                pic_pos = pos
                pend = None
            elif code == 0xB7:
                if pic_pos is not None:
                    return self._emit(pic_start, pos, pic_pos)
                return None
            else:
                pend = None
        if pic_pos is not None and self._eos:
            return self._emit(pic_start, len(self._buf), pic_pos)
        return None

    def _emit(self, start: int, end: int, pic_pos: int) -> PictureData:
        assert self.seq is not None, "picture before sequence header"
        chunk = bytes(self._buf[start:end])
        # picture header fields, direct byte math (temporal_ref 10b,
        # type 3b; P adds vbv 16b, full_pel 1b, f_code 3b)
        d = bytes(self._buf[pic_pos + 4:pic_pos + 4 + 8]) + b"\0" * 8
        ptype = (d[1] >> 3) & 7
        full_pel = r_size = 0
        if ptype == 2:
            full_pel = (d[3] >> 2) & 1
            r_size = (((d[3] & 3) << 1) | (d[4] >> 7)) - 1
        # PTS: newest mark at or before the picture position
        abs_pic = self._base + pic_pos
        while self._pts_marks and self._pts_marks[0][0] <= abs_pic:
            self._last_pts = self._pts_marks.popleft()[1]
        pts = self._last_pts

        pic = PictureData(ptype, full_pel, r_size, self.seq, pts=pts)
        if ptype in (1, 2):
            # slice start codes inside [start, end) are already in the
            # incremental cache; no rescan of the chunk
            sl = [(p - start, c) for p, c in self._code_list
                  if start <= p < end and 0x01 <= c <= 0xAF]
            if sl:
                base = sl[0][0]
                pic.payload = chunk[base:]
                pic.slice_offsets = [(p - base) * 8 + 32 for p, _ in sl]
                pic.slice_rows = [c - 1 for _, c in sl]
        self._consume(end)
        return pic


@dataclass
class SbcRing:
    """Audio byte ring with frame-size self-discovery
    (video.cpp:957-987 semantics, unbounded host-side)."""
    buf: bytearray = field(default_factory=bytearray)
    frame_size: int = 0
    channels: int = 1       # discovered with frame_size (header mode)
    blocks: int = 16        # discovered blocks/frame
    pts: int = -1           # latest PES pts (90 kHz)

    def push(self, data: bytes, pts: int):
        if pts != -1:
            self.pts = pts
        self.buf += data

    def discover(self, probe) -> int:
        """probe(bytes) -> frame_len or (frame_len, channels, blocks);
        returns frame size (0 if unknown)."""
        if not self.frame_size and len(self.buf) >= 64:
            n = probe(bytes(self.buf[:min(len(self.buf), 512)]))
            ch, bl = 1, 16
            if isinstance(n, tuple):
                n, ch, bl = n
            if n and n > 0:
                self.frame_size = n
                self.channels = ch
                self.blocks = bl
        return self.frame_size

    def clear(self):
        """Drop all buffered bytes (fault-injection / flush paths)."""
        self.buf.clear()

    def size(self) -> int:
        return len(self.buf)

    def poke(self, off: int, value: int):
        """Overwrite one buffered byte (fault injection)."""
        self.buf[off] = value

    def pop_frames(self, max_frames: int) -> list[bytes]:
        if not self.frame_size:
            return []
        out = []
        while len(out) < max_frames and len(self.buf) >= self.frame_size:
            out.append(bytes(self.buf[:self.frame_size]))
            del self.buf[:self.frame_size]
        return out

    def pop_frames_array(self, max_frames: int):
        """Up to max_frames frames as ONE uint8[k, frame_size] array
        (single copy; the per-frame bytes loop showed up in the
        1k-lane host profile)."""
        fs = self.frame_size
        if not fs:
            return None
        k = min(max_frames, len(self.buf) // fs)
        if k == 0:
            return None
        out = np.frombuffer(self.buf, np.uint8)[:k * fs] \
            .reshape(k, fs).copy()
        del self.buf[:k * fs]
        return out


def native_demux_available() -> bool:
    """Whether StreamFeed walks packets with the native C++ demuxer
    (built at the first call) rather than the numpy walker."""
    return NT.available()


class StreamFeed:
    """TS bytes in -> pictures + audio out (incremental).

    Packet walking goes through the BULK demuxer -- the native C++
    one (native/ts_demux.cpp via streaming/native.py) when built,
    else the vectorized numpy walker -- instead of a per-packet
    Python loop (the reference dedicates a core to this pump,
    espflix.cpp:723-737; at 1k lanes the Python walk dominated the
    host profile).
    """

    def __init__(self):
        self.es = EsSegmenter()
        self.audio = SbcRing()
        self._tail = b""
        self.sync_lost = False
        self._audio_started = False

    def feed(self, data: bytes):
        data = self._tail + data
        n = len(data) // TS_PACKET
        self._tail = data[n * TS_PACKET:]
        if not n:
            return
        r = NT.demux_ts(data[:n * TS_PACKET], self._audio_started)
        if r.sync_lost:
            self.sync_lost = True
        pos = 0
        video = r.video
        for off, pts in r.video_pts_marks:
            if off > pos:
                self.es.push(video[pos:off])
                pos = off
            self.es.mark_pts(pts)
        if pos < len(video):
            self.es.push(video[pos:])
        for ch in r.audio:
            self._audio_started = True
            self.audio.push(ch.data, ch.pts)

    def eos(self):
        self.es.eos()

    def pop_picture(self):
        return self.es.pop_picture()


def make_stream_feed():
    """Production feed: the native (C++-state) session feed when the
    library is built (streaming/native_feed.NativeStreamFeed), else the
    Python StreamFeed.  ESPFLIX_NATIVE_FEED=0 forces the Python path
    (tests compare both for bit-identity)."""
    if os.environ.get("ESPFLIX_NATIVE_FEED", "1") != "0":
        try:
            from espflix_tpu_torch.streaming.native_feed import \
                NativeStreamFeed
            return NativeStreamFeed()
        except Exception:
            pass
    return StreamFeed()
