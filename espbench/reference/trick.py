"""Trick play and seeks as the upstream player does them: the video.idx
math, the remote's dispatch rules and where each seek lands.

Plain Python and NumPy, written for the benchmark from the upstream
sources; it imports nothing of the program.

- ``Index``: a title's video.idx (indexer/indexer.cpp:22-36, 176-232):
  a header of three records (main, forward, rewind stream: first and
  last PTS, bin size, trick speed, sample count) and three u32 arrays
  of 188-byte packet indices, one a bin.  ``pts2offset`` and
  ``pts2pts`` are espflix.cpp:589-628; ``packet`` is the 4-byte read
  of espflix.cpp:823-829.
- ``sequence_points``: the packets of a transport stream at which a
  video PES opens on a sequence header, with that PES's PTS: where a
  seek may land, and the picture a play presents first from there.
- ``Lane``: one lane's player as the remote drives it (espflix.cpp:
  787-848, 941-1008): its state, speed, saved position and the
  picture it must present next.  A key returns what it did; a play
  lands on the index's packet for the saved position and presents from
  that packet's picture on, one picture a tick, up to its stream's end.
"""

from __future__ import annotations

import struct

import numpy as np

PTS_HZ = 90000
VIDEO_PID = 0x100
_REC = struct.Struct("<qqIII4x")     # the C struct, padded to 32 bytes
_HEAD = struct.Struct("<II")
HDR_SIZE = _HEAD.size + 3 * _REC.size
IDX_SIG = 0x584449                   # 'IDX'

# the remote's key codes (espflix.cpp key_event mapping)
KEY_MENU, KEY_PLAY, KEY_SELECT = 16, 19, 40
KEY_RIGHT, KEY_LEFT, KEY_DOWN, KEY_UP = 79, 80, 81, 82

PLAYING, PAUSED, FAST_FORWARD, REWIND, DONE = (
    "PLAYING", "PAUSED", "FAST_FORWARD", "REWIND", "DONE")
STATE_OF_SPEED = {0: PLAYING, 1: FAST_FORWARD, -1: REWIND}


class Index:
    """One title's video.idx."""

    def __init__(self, data: bytes):
        sig, n = _HEAD.unpack_from(data, 0)
        if sig != IDX_SIG or n != 3:
            raise ValueError("not a video.idx")
        self.data = data
        # rec[speed]: (first_pts, last_pts, bin_size, trick_speed, count)
        recs = [_REC.unpack_from(data, _HEAD.size + k * _REC.size)
                for k in range(3)]
        self.rec = {0: recs[0], 1: recs[1], -1: recs[2]}

    def pts2offset(self, pts: int, speed: int) -> int:
        """The byte offset in video.idx of the sample for main-stream
        time `pts` in the stream of `speed` (espflix.cpp:606-628)."""
        v0, v1, vbin, _s, vn = self.rec[0]
        pts = max(min(pts, v1), v0)
        if speed == 0:
            k = min(vn - 1, (pts - v0) // vbin)
        elif speed == 1:
            _f0, _f1, fbin, fspeed, fn = self.rec[1]
            k = vn + min(fn - 1, (pts - v0) // fspeed // fbin)
        else:
            _r0, _r1, rbin, rspeed, rn = self.rec[-1]
            fn = self.rec[1][4]
            k = vn + fn + min(rn - 1, ((v1 - pts) - v0) // rspeed // rbin)
        return HDR_SIZE + 4 * k

    def pts2pts(self, pts: int, speed: int) -> int:
        """A PTS of the stream of `speed` as main-stream time
        (espflix.cpp:589-604)."""
        if speed == 0:
            return pts
        v0, v1 = self.rec[0][:2]
        t0, t1 = self.rec[speed][:2]
        span = t1 - t0
        mapped = (pts - t0) * (v1 - v0) // span if span else 0
        return v0 + mapped if speed == 1 else v1 - mapped

    def packet(self, speed: int, pts: int) -> int:
        """The 4-byte read: the packet a play of `speed` at main-stream
        time `pts` opens at."""
        off = self.pts2offset(pts, speed)
        return struct.unpack_from("<I", self.data, off)[0]


def sequence_points(ts: bytes) -> tuple[dict, int]:
    """({packet: pts} of every video PES that opens on a sequence header,
    the stream's last video PTS)."""
    a = np.frombuffer(ts, np.uint8)
    a = a[:len(a) // 188 * 188].reshape(-1, 188)
    pid = ((a[:, 1].astype(np.int32) << 8) | a[:, 2]) & 0x1FFF
    starts = np.flatnonzero((a[:, 0] == 0x47) & (pid == VIDEO_PID)
                            & (a[:, 1] & 0x40 != 0) & (a[:, 3] & 0x10 != 0))
    points, last = {}, -1
    for k in starts:
        d = a[k]
        o = 5 + int(d[4]) if d[3] & 0x20 else 4
        p = bytes(d[o:])
        if p[:3] != b"\x00\x00\x01" or not p[7] & 0x80:
            continue
        b = p[9:14]
        pts = (((b[0] >> 1) & 7) << 30) | (b[1] << 22) \
            | ((b[2] >> 1) << 15) | (b[3] << 7) | (b[4] >> 1)
        last = max(last, pts)
        es = p[9 + p[8]:]
        if es[:4] == b"\x00\x00\x01\xb3":
            points[int(k)] = pts
    return points, last


class Title:
    """What the reference knows of a title: its index, and per stream
    (speed 0, 1, -1) its sequence points and last PTS."""

    def __init__(self, idx: bytes, streams: dict):
        self.index = Index(idx)
        self.points, self.last = {}, {}
        for speed, ts in streams.items():
            self.points[speed], self.last[speed] = sequence_points(ts)

    def landing(self, speed: int, pos: int) -> int:
        """The PTS of the first picture a play of `speed` from main-stream
        time `pos` presents: the picture of the index's packet."""
        q = self.index.packet(speed, pos)
        if q not in self.points[speed]:
            raise ValueError(f"packet {q} of stream {speed} opens no "
                             "sequence")
        return self.points[speed][q]


class Lane:
    """One lane's player under the remote (see the module's docstring).
    `per` is the PTS ticks a picture; `next_pts` the PTS its next
    presented picture must carry, `fresh` whether that picture is the
    first of its play."""

    def __init__(self, per: int):
        self.per = per
        self.title = None
        self.state = None
        self.speed = 0
        self.pos = 0
        self.last_pts = -1
        self.next_pts = -1
        self.fresh = False

    def start(self, title: Title, pos: int):
        """Navigate to `title` with `pos` saved and press PLAY
        (espflix.cpp:787-797 from NAV)."""
        self.title, self.pos = title, pos
        self.play(0)

    def play(self, speed: int):
        """Open the stream of `speed` at the index's packet for the saved
        position."""
        self.speed = speed
        self.state = STATE_OF_SPEED[speed]
        self.next_pts = self.title.landing(speed, self.pos)
        self.last_pts = -1
        self.fresh = True

    def save_pos(self):
        """The current stream's last presented PTS as main-stream time
        (espflix.cpp:851-859); nothing before the play's first picture."""
        if self.last_pts >= 0:
            self.pos = self.title.index.pts2pts(self.last_pts, self.speed)

    def key(self, key: int) -> bool:
        """Dispatch a key (espflix.cpp:941-1008); whether it opened a
        stream.  MENU and the navigation keys of the title menu are out of
        this model's scope."""
        st = self.state
        if key in (KEY_PLAY, KEY_SELECT):
            if st in (PLAYING, FAST_FORWARD, REWIND):
                self.save_pos()
                if self.speed:
                    self.play(0)
                    return True
                self.state = PAUSED
            elif st == PAUSED:
                self.state = PLAYING
            return False
        if key in (KEY_RIGHT, KEY_LEFT) and st in (PLAYING, PAUSED):
            self.save_pos()
            self.play(-1 if key == KEY_LEFT else 1)
            return True
        if key in (KEY_UP, KEY_DOWN) and st == PLAYING:
            self.save_pos()
            self.pos = max(0, self.pos + (30 if key == KEY_UP else -30)
                           * PTS_HZ)
            self.play(0)
            return True
        return False

    @property
    def exhausted(self) -> bool:
        """Whether the play has presented its stream's last picture."""
        return self.next_pts > self.title.last[self.speed]

    def present(self):
        """The play presents its next picture."""
        self.last_pts = self.next_pts
        self.next_pts += self.per
        self.fresh = False
        self.save_pos()

    def idle_tick(self):
        """A tick that presents nothing: a play past its stream's end is
        DONE (the player's end of stream)."""
        if self.state in (PLAYING, FAST_FORWARD, REWIND) and self.exhausted:
            self.state = DONE
