"""Read-only mappings of title files: the served gather's pump reads.

Fleet._gather_batch_packed (runtime/scheduler.py) serves the pump reads
of a lane whose Streamer has a regular file open from a read-only
mapping of that file, in place of ``Streamer.read``: the native pump
(streaming/native_pump.py) feeds straight from the mapping at the
lane's cursor, with no syscall and no ``bytes`` per lane.
Every lane on one file shares its mapping, keyed by the file's
(st_dev, st_ino, st_size, st_mtime_ns); a mapping goes when its last
lane leaves.

While a lane is attached, this table owns its read cursor (the absolute
byte position) and its end (``_offset + _content_length``, capped at the
mapped size), so the bytes are those ``Streamer.read`` would return.
Sockets and ``get_rom`` buffers stay on ``Streamer.read``, as does a
Streamer whose ``read`` is overridden.  A lane that leaves with the same
file still open gets its cursor back (``_mark`` and the file's
position), so its next ``Streamer.read`` continues at the right byte; a
lane whose Streamer reopened its file (play, skip, resync, trick play)
is attached again from the Streamer's fresh state.

Limit: a mapping is bounded by the file's size when it was mapped; a
title truncated while a lane plays it would fault on the next read
(SIGBUS).  Titles are immutable while they are served.
"""

from __future__ import annotations

import mmap
import os
import stat

import numpy as np

from espflix_tpu_torch.streaming.streamer import Streamer


def file_key(f):
    """(st_dev, st_ino, st_size, st_mtime_ns) of the open file `f` when
    it is a regular file of at least one byte, else None."""
    try:
        st = os.fstat(f.fileno())
    except (OSError, ValueError):
        return None
    if not stat.S_ISREG(st.st_mode) or st.st_size == 0:
        return None
    return st.st_dev, st.st_ino, st.st_size, st.st_mtime_ns


def _mapped_file(st):
    """The regular file `st` (a Streamer) reads through Streamer.read's
    file branch, or None."""
    f = getattr(st, "_file", None)
    if (f is None or getattr(st, "_rom", None) is not None
            or type(st).read is not Streamer.read or "read" in st.__dict__):
        return None
    return f


class TitleMaps:
    """The mapped files and, per fleet lane, its mapping, the mapping's
    address, its cursor and end (numpy arrays; ``src`` -1 where the
    lane is not attached)."""

    def __init__(self, n_lanes: int, chunk: int):
        self.chunk = chunk
        self.src = np.full(n_lanes, -1, np.int64)   # mapping id
        self.pos = np.zeros(n_lanes, np.int64)      # absolute position
        self.end = np.zeros(n_lanes, np.int64)      # absolute end
        self.nlane = np.zeros(n_lanes, np.int32)    # native feed lane
        self.base = np.zeros(n_lanes, np.uint64)    # mapping's address
        self._st = [None] * n_lanes     # the Streamer attached from
        self._f = [None] * n_lanes      # and its file object then
        self._ids = {}                  # file key -> mapping id
        self._maps = {}                 # id -> [flat bytes, key, lanes]
        self._next = 0

    def sync(self, lanes, streamers, feeds):
        """Once a tick, before the pump rounds: `lanes` may read from
        mappings (with their Streamers and native feed lanes).  Attaches
        those not attached, or whose Streamer or file changed, and
        detaches every other attached lane.  Returns how many lanes it
        attached."""
        keep = np.zeros(len(self.src), bool)
        attached = 0
        for i, st in zip(lanes, streamers):
            f = self._f[i]
            if f is not None:
                if self._st[i] is st and st._file is f:
                    keep[i] = True
                    continue
                self._detach(i)
            keep[i] = self._attach(i, st)
            attached += keep[i]
        if len(lanes):
            self.nlane[lanes] = feeds
        for i in np.flatnonzero((self.src >= 0) & ~keep):
            self._detach(int(i))
        return int(attached)

    def release(self):
        """Detach every lane (before a gather that reads the Streamers)."""
        for i in np.flatnonzero(self.src >= 0):
            self._detach(int(i))

    def _attach(self, i: int, st) -> bool:
        f = _mapped_file(st)
        key = None if f is None else file_key(f)
        if key is None:
            return False
        mid = self._ids.get(key)
        if mid is None:
            mid = self._next
            self._next += 1
            flat = np.frombuffer(mmap.mmap(f.fileno(), 0,
                                           access=mmap.ACCESS_READ),
                                 np.uint8)
            self._ids[key] = mid
            self._maps[mid] = [flat, key, 0]
        m = self._maps[mid]
        m[2] += 1
        pos = st._offset + st._mark
        self.src[i] = mid
        self.base[i] = m[0].ctypes.data
        self.pos[i] = pos
        self.end[i] = min(max(st._offset + st._content_length, pos),
                          len(m[0]))
        self._st[i], self._f[i] = st, st._file
        return True

    def _detach(self, i: int):
        st, f = self._st[i], self._f[i]
        mid = int(self.src[i])
        if st._file is f:
            # hand the cursor back to the Streamer
            pos = int(self.pos[i])
            st._mark = pos - st._offset
            f.seek(pos)
        self._st[i] = self._f[i] = None
        self.src[i] = -1
        self.base[i] = 0
        m = self._maps[mid]
        m[2] -= 1
        if m[2] == 0:
            del self._ids[m[1]], self._maps[mid]
