"""Trick-play index: the video.idx format and PTS<->offset math.

Copied from espflix_tpu/streaming/index.py; tests/test_torch_isolation.py
pins the copy to the original.

Binary-compatible with the reference's index files and exactly its
mapping math (src/espflix.cpp:573-629 and
indexer/indexer.cpp:22-36):

    idx_hdr { u32 sig('IDX'), u32 len(3),
              idx_rec video, fwd, rwd }
    idx_rec { i64 first_pts, i64 last_pts, u32 bin_size,
              u32 trick_speed, u32 sample_count }  (packed, 8+8+4+4+4)

followed by three u32 arrays of 188-byte-packet indices binned at
bin_size PTS ticks (90000/12 = 1/12 s).  Seeks are O(1): one 4-byte
ranged read at pts2offset() yields the packet index to stream from.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

IDX_SIG = (ord("I")) | (ord("D") << 8) | (ord("X") << 16)
# C struct layout: int64 x2, uint32 x3, padded to 8-byte alignment (the
# reference fwrites the raw struct, indexer.cpp:232 -> 32-byte records)
_REC = struct.Struct("<qqIII4x")
_HDR_HEAD = struct.Struct("<II")
HDR_SIZE = _HDR_HEAD.size + 3 * _REC.size
BIN_SIZE = 90000 // 12


@dataclass
class IdxRec:
    first_pts: int = 0
    last_pts: int = 0
    bin_size: int = BIN_SIZE
    trick_speed: int = 1
    sample_count: int = 0

    def pack(self) -> bytes:
        return _REC.pack(self.first_pts, self.last_pts, self.bin_size,
                         self.trick_speed, self.sample_count)

    @classmethod
    def unpack(cls, b: bytes) -> "IdxRec":
        return cls(*_REC.unpack(b))


@dataclass
class IdxHdr:
    video: IdxRec
    fwd: IdxRec
    rwd: IdxRec

    def pack(self) -> bytes:
        return _HDR_HEAD.pack(IDX_SIG, 3) + self.video.pack() \
            + self.fwd.pack() + self.rwd.pack()

    @classmethod
    def unpack(cls, b: bytes) -> "IdxHdr":
        sig, ln = _HDR_HEAD.unpack_from(b, 0)
        assert sig == IDX_SIG and ln == 3, "bad video.idx header"
        o = _HDR_HEAD.size
        recs = [IdxRec.unpack(b[o + i * _REC.size:o + (i + 1) * _REC.size])
                for i in range(3)]
        return cls(*recs)

    # -- PTS mapping (espflix.cpp:589-604) ------------------------------
    def map_pts(self, pts: int, r: IdxRec) -> int:
        pts -= r.first_pts
        pts *= self.video.last_pts - self.video.first_pts
        span = r.last_pts - r.first_pts
        return pts // span if span else 0

    def pts2pts(self, pts: int, speed: int) -> int:
        """Trick-stream PTS -> main-stream PTS at the given speed."""
        if speed == 1:
            return self.video.first_pts + self.map_pts(pts, self.fwd)
        if speed == -1:
            return self.video.last_pts - self.map_pts(pts, self.rwd)
        return pts

    def pts2offset(self, pts: int, speed: int) -> int:
        """Main-stream PTS -> byte offset of the u32 sample to read from
        video.idx (espflix.cpp:606-628)."""
        pts = max(min(pts, self.video.last_pts), self.video.first_pts)
        if speed == 1:
            offset = (pts - self.video.first_pts) \
                // self.fwd.trick_speed // self.fwd.bin_size
            offset = min(self.fwd.sample_count - 1, offset)
            offset += self.video.sample_count
        elif speed == -1:
            offset = ((self.video.last_pts - pts)
                      - self.video.first_pts) \
                // self.rwd.trick_speed // self.rwd.bin_size
            offset = min(self.rwd.sample_count - 1, offset)
            offset += self.video.sample_count + self.fwd.sample_count
        else:
            offset = (pts - self.video.first_pts) // self.video.bin_size
            offset = min(self.video.sample_count - 1, offset)
        return offset * 4 + HDR_SIZE


def get_index(streamer, url: str, hdr: IdxHdr, speed: int,
              pts: int) -> int:
    """One 4-byte ranged read -> packet index (espflix.cpp:823-829)."""
    off = hdr.pts2offset(pts, speed)
    b = streamer.get_url(url, off, 4)
    if not b or len(b) < 4:
        return 0
    return struct.unpack("<I", b)[0]


def fetch_header(streamer, url: str) -> IdxHdr | None:
    b = streamer.get_url(url, 0, HDR_SIZE)
    if not b or len(b) < HDR_SIZE:
        return None
    return IdxHdr.unpack(b)
