"""Read-only mappings of title files: the served gather's pump reads.

Fleet._gather_batch_packed (runtime/scheduler.py) serves the pump reads
of a lane whose Streamer has a regular file open from a read-only
mapping of that file, in place of ``Streamer.read``: one numpy gather
per mapped file a pump round, no syscall and no ``bytes`` per lane.
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
    """The mapped files and, per fleet lane, its mapping, cursor and end
    (numpy arrays; ``src`` -1 where the lane is not attached)."""

    def __init__(self, n_lanes: int, chunk: int):
        self.chunk = chunk
        self.src = np.full(n_lanes, -1, np.int64)   # mapping id
        self.pos = np.zeros(n_lanes, np.int64)      # absolute position
        self.end = np.zeros(n_lanes, np.int64)      # absolute end
        self.nlane = np.zeros(n_lanes, np.int32)    # native feed lane
        self._st = [None] * n_lanes     # the Streamer attached from
        self._f = [None] * n_lanes      # and its file object then
        self._ids = {}                  # file key -> mapping id
        self._maps = {}                 # id -> [flat bytes, rows, key, lanes]
        self._next = 0
        # a pump round's bytes, at most a chunk a lane
        self.buf = np.empty(n_lanes * chunk, np.uint8)

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
            rows = None
            if len(flat) >= self.chunk:
                # row p is the chunk at byte p (rows overlap)
                rows = np.lib.stride_tricks.as_strided(
                    flat, (len(flat) - self.chunk + 1, self.chunk), (1, 1),
                    writeable=False)
            self._ids[key] = mid
            self._maps[mid] = [flat, rows, key, 0]
        m = self._maps[mid]
        m[3] += 1
        pos = st._offset + st._mark
        self.src[i] = mid
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
        m = self._maps[mid]
        m[3] -= 1
        if m[3] == 0:
            del self._ids[m[2]], self._maps[mid]

    def gather(self, idx, start: int = 0):
        """A pump round's reads for the attached lanes `idx`: each
        lane's next min(chunk, end - pos) bytes, back to back in ``buf``
        from byte `start`, one fancy-indexed gather per mapping (short
        tails one by one).  Advances the cursors.  Returns (order, lens,
        nbytes): `lens` the bytes each lane of `idx` got (0 at its end),
        `order` the positions in `idx` of the lanes that got bytes, in
        the order their bytes lie in ``buf``, and their total."""
        c = self.chunk
        pos = self.pos[idx]
        lens = np.clip(self.end[idx] - pos, 0, c)
        src = self.src[idx]
        full = np.flatnonzero(lens == c)
        full = full[np.argsort(src[full], kind="stable")]
        o = start
        # np.take would first copy the overlapping row view whole
        for grp in np.split(full, np.flatnonzero(np.diff(src[full])) + 1):
            if len(grp):
                rows = self._maps[int(src[grp[0]])][1]
                m = len(grp) * c
                self.buf[o:o + m].reshape(-1, c)[:] = rows[pos[grp]]
                o += m
        tails = np.flatnonzero((lens > 0) & (lens < c))
        for k in tails:
            n, p = int(lens[k]), int(pos[k])
            self.buf[o:o + n] = self._maps[int(src[k])][0][p:p + n]
            o += n
        self.pos[idx] = pos + lens
        return np.concatenate([full, tails]), lens, o - start
