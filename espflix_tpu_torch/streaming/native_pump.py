"""A lane-parallel pump for the served gather's mapped lanes: ctypes
facade over streaming/native_pump.cpp.

The served gather (runtime/packed_gather.py) hands every lane that
reads from a title mapping (streaming/title_maps.py) to ONE ``Pump.run``
call a tick.  Each lane runs the gather's pump rounds on its own: pop
its next picture straight into the batch layout (the session feed's
``sf_pop_pictures_packed`` on that one lane); when starved, feed the
next min(chunk, end - pos) bytes of its mapping (``sf_feed``, a pointer
into the mapping at the lane's cursor) and pop again, at most
`max_rounds` pops.  A lane stops at a picture, at a capacity rc (< 0;
the caller pops it through the growable path) or at its title's end
(the caller runs the EOS branch).  The pops and feeds are the feed
library's own entry points, passed in as function pointers, so the
bytes and every per-lane step are the round loop's and the batch rows
bit-identical (tests/test_torch_native_feed.py).

Lanes share no state in the feed library, so threads split them: the
process's pool (``get_pump``) keeps workers that sleep on a condition
variable between calls; a call wakes as many as its lanes warrant
(``_threads``; a HostPool worker caps them at its share of the CPUs),
and they take lanes in small blocks beside the calling thread.  The
ctypes call drops the GIL; no Python runs on the workers.
The pool is joined at exit.

The library builds at first use with g++ into
``<repo>/build/pump-<hash>/`` (utils/hostbuild.py, keyed by a hash of
the source and the flags); a failed build raises.
"""

from __future__ import annotations

import atexit
import ctypes
import os
from pathlib import Path

import numpy as np

from espflix_tpu_torch.streaming import native_feed as NF
from espflix_tpu_torch.utils import hostbuild

SOURCE = Path(__file__).resolve().with_name("native_pump.cpp")
CXXFLAGS = ("-O3", "-pthread", "-fPIC", "-std=c++17", "-Wall", "-Wextra")
# lanes that keep one thread busy for long enough to pay its wake-up
LANES_PER_THREAD = 64

_lib = None
_pump: Pump | None = None


def build() -> Path:
    """Compile native_pump.cpp unless the library for this source and
    these flags exists; returns its path."""
    return hostbuild.shared_library("pump", "libespflix_pump.so", [SOURCE],
                                    CXXFLAGS)


def lib() -> ctypes.CDLL:
    """The pump library, built on first call."""
    global _lib
    if _lib is None:
        L = ctypes.CDLL(str(build()))
        c = ctypes
        L.np_pool_create.restype = c.c_void_p
        L.np_pool_create.argtypes = []
        L.np_pool_destroy.restype = None
        L.np_pool_destroy.argtypes = [c.c_void_p]
        L.np_pump.restype = c.c_int
        L.np_pump.argtypes = (
            [c.c_void_p, c.c_int] + [c.c_void_p] * 3 + [c.c_int]
            + [c.c_void_p] * 5 + [c.c_long, c.c_int, c.c_void_p, c.c_long]
            + [c.c_void_p] * 4 + [c.c_int, c.c_void_p, c.c_int]
            + [c.c_void_p] * 6)
        _lib = L
    return _lib


def _threads(n_lanes: int) -> int:
    """Threads for a call over `n_lanes` lanes: one per LANES_PER_THREAD
    lanes, at most the CPUs this process may run on."""
    return max(1, min(len(os.sched_getaffinity(0)),
                      -(-n_lanes // LANES_PER_THREAD)))


class PumpResult:
    """Per lane of a call: rc (1 picture, 0 none, < 0 capacity), meta
    [n, M_COUNT], iq8 / nq8 [n, 64], rounds (pops), fed (bytes) and
    ended (its title's end reached starved); `threads` took part."""

    def __init__(self, n: int):
        self.rc = np.zeros(n, np.int32)
        self.meta = np.zeros((n, NF.M_COUNT), np.int64)
        self.iq8 = np.zeros((n, 64), np.uint8)
        self.nq8 = np.zeros((n, 64), np.uint8)
        self.rounds = np.zeros(n, np.int32)
        self.fed = np.zeros(n, np.int64)
        self.ended = np.zeros(n, np.uint8)
        self.threads = 0


class Pump:
    """A thread pool of the pump library (workers started on first
    need, joined by close)."""

    def __init__(self):
        self.L = lib()
        self.handle = self.L.np_pool_create()
        F = NF.lib()
        self._pop = ctypes.cast(F.sf_pop_pictures_packed,
                                ctypes.c_void_p).value
        self._feed = ctypes.cast(F.sf_feed, ctypes.c_void_p).value

    def close(self):
        h, self.handle = self.handle, None
        if h is not None:
            self.L.np_pool_destroy(h)

    def run(self, pb: NF.PackedBatch, tm, slots, max_rounds: int,
            cpus: int | None = None):
        """Pump the mapped lanes at fleet slots `slots` (each attached in
        TitleMaps `tm`; its cursor advances in place) into `pb`'s rows,
        on at most `cpus` threads (None: every CPU this process may run
        on).  Returns a PumpResult in the order of `slots`."""
        slots = np.ascontiguousarray(slots, np.int32)
        n = len(slots)
        out = PumpResult(n)
        if n == 0:
            return out
        assert (tm.src[slots] >= 0).all() and len(np.unique(slots)) == n
        for a, dt in ((tm.nlane, np.int32), (tm.base, np.uint64),
                      (tm.pos, np.int64), (tm.end, np.int64),
                      (pb.words, np.uint32), (pb.prev_nw, np.int32),
                      (pb.n_words, np.int32),
                      (pb.slice_starts, np.int32),
                      (pb.slice_rows, np.int32)):
            assert a.dtype == dt and a.flags.c_contiguous
        threads = _threads(n) if cpus is None else min(cpus, _threads(n))
        out.threads = self.L.np_pump(
            self.handle, threads, self._pop, self._feed,
            NF.get_pool().handle, n, slots.ctypes.data,
            tm.nlane.ctypes.data, tm.base.ctypes.data, tm.pos.ctypes.data,
            tm.end.ctypes.data, tm.chunk, max_rounds,
            pb.words.ctypes.data, pb.words_per_lane,
            pb.prev_nw.ctypes.data, pb.n_words.ctypes.data,
            pb.slice_starts.ctypes.data, pb.slice_rows.ctypes.data,
            pb.max_slices, out.meta.ctypes.data, out.meta.shape[1],
            out.iq8.ctypes.data,
            out.nq8.ctypes.data, out.rc.ctypes.data,
            out.rounds.ctypes.data, out.fed.ctypes.data,
            out.ended.ctypes.data)
        return out


def get_pump() -> Pump:
    """The process's Pump (made, and its library built, on first
    call)."""
    global _pump
    if _pump is None:
        _pump = Pump()
    return _pump


def _close():
    if _pump is not None:
        _pump.close()


def _forget():
    # a forked child has none of the parent's workers
    global _pump
    _pump = None


atexit.register(_close)
os.register_at_fork(after_in_child=_forget)
