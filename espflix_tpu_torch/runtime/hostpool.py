"""Host worker pool: the session control plane sharded across cores.

The port of espflix_tpu.runtime.hostpool.  The reference dedicates one
CPU core per stream to the network pump + demux (espflix.cpp:723-737);
a fleet serves thousands of lanes, so the host side must be O(cores),
not O(lanes) on one core.  This module shards the PlayerSessions across
worker PROCESSES by contiguous lane range.  Each worker owns its lanes
end to end -- streamer I/O, TS demux and ES segmentation (the native
session feed when built), SBC rings, control actions -- and per tick
returns its shard's device-ready numpy arrays: the span-sorted slice-row
pack in device windows + row permutation (the per-shard layout of
ops/scan_dense.pack_slice_rows_sharded) plus the audio frames, as
runtime/chunk_layout.tick_inputs lays them out.  The parent only
concatenates shard blobs and runs the device chain
(Fleet.run_chunk_full_pooled).

A worker never touches the card and never imports torch: it is a fresh
interpreter (``python -m espflix_tpu_torch.runtime.hostpool``, started
with exec, never a fork of the parent, which holds a CUDA context) whose
environment has CUDA_VISIBLE_DEVICES="", and it imports only the
torch-free host modules (models/mpeg1_host.py, ops/host_pack.py,
runtime/host_gather.py, runtime/packed_gather.py,
runtime/chunk_layout.py, runtime/player.py, the session feeds, the
title mappings and the native pump).  It gathers through the in-process
Fleet's own gather (runtime/packed_gather.PackedGather: mapped lanes in
one threaded native pump call, the lanes off the mappings in packed pop
rounds, Python-feed lanes through next_picture), so it admits, drops
and re-seeks pictures as the Fleet does, and returns the events it
would have logged and its feed counts.  Its pump takes its share of the
CPUs, max(1, CPUs // W).  Parent and worker talk through a
multiprocessing Connection over a socket pair; a gather reply goes as
one frame (_send_frame), pickled with its arrays' bytes out of band, in
one write into a send buffer asked large enough to hold it, and the
parent reads the replies as they come, each into a buffer it keeps for
that worker: pickling copies none of the arrays on either side.
Presentation goes once a chunk, one message a worker.  Control actions
(seek/pause/trick), attach and state (one message a lane, or one a
worker: attach_many, states) and snapshot/restore route to workers as
messages and apply between ticks -- the same boundary semantics as the
chunked dispatch.
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import subprocess
import sys
import time
import weakref
from multiprocessing.connection import Connection, wait
from pathlib import Path

import numpy as np

from espflix_tpu_torch.runtime import chunk_layout as CL
from espflix_tpu_torch.runtime import host_gather as HG

__all__ = ["HostPool"]

_REPO = Path(__file__).resolve().parent.parent.parent
# a worker's socket send buffer: room for a whole gather reply (the
# kernel caps it at its own net.core.wmem_max)
_SNDBUF = 8 << 20


def _aligned(n: int) -> int:
    return (n + 15) & ~15


def _send_frame(fd: int, obj) -> None:
    """Write `obj` to `fd` as one frame: pickled (protocol 5) with its
    contiguous arrays' bytes out of band, so no copy of them is made on
    this side.  The frame: the number of parts, each part's length, then
    the pickle and the arrays' bytes, each part padded to 16 bytes."""
    bufs = []
    meta = pickle.dumps(obj, protocol=5, buffer_callback=bufs.append)
    parts = [memoryview(meta)] + [b.raw() for b in bufs]
    views = [memoryview(struct.pack(f"<I{len(parts)}Q", len(parts),
                                    *(p.nbytes for p in parts)))]
    for p in parts:
        views += [p, memoryview(bytes(_aligned(p.nbytes) - p.nbytes))]
    while views:
        n = os.writev(fd, views)
        while views and n >= views[0].nbytes:
            n -= views.pop(0).nbytes
        if n:
            views[0] = views[0][n:]


def _frame_reader(sock, held: list):
    """Read one _send_frame frame from `sock` without blocking: a
    generator that yields whenever no byte is waiting, and returns the
    object and the frame's bytes.  The frame lands in the buffer held[0]
    (grown as needed, and reused: the object's arrays are views of it,
    valid until the next frame read into it)."""
    def fill(mv):
        while mv.nbytes:
            try:
                n = sock.recv_into(mv, 0, socket.MSG_DONTWAIT)
            except BlockingIOError:
                yield
                continue
            if n == 0:
                raise EOFError("a worker closed its socket")
            mv = mv[n:]
    head = bytearray(4)
    yield from fill(memoryview(head))
    k, = struct.unpack("<I", head)
    lens = bytearray(8 * k)
    yield from fill(memoryview(lens))
    lens = struct.unpack(f"<{k}Q", lens)
    size = sum(_aligned(n) for n in lens)
    if len(held[0]) < size:
        held[0] = bytearray(size)
    buf = memoryview(held[0])[:size]
    yield from fill(buf)
    parts, o = [], 0
    for n in lens:
        parts.append(buf[o:o + n])
        o += _aligned(n)
    return pickle.loads(parts[0], buffers=parts[1:]), 4 + 8 * k + o


def _recv_frames(socks, helds) -> list:
    """One frame from each socket of `socks`, read side by side: every
    byte waiting on any of them is taken before this waits, so a worker
    whose reply outgrows its socket's buffer writes on while the others'
    are read.  Returns [(object, frame bytes)] in the order of
    `socks`."""
    readers = {k: _frame_reader(sk, held)
               for k, (sk, held) in enumerate(zip(socks, helds))}
    out = [None] * len(socks)
    while readers:
        for k in list(readers):
            try:
                next(readers[k])
            except StopIteration as done:
                out[k] = done.value
                del readers[k]
        if readers:
            wait([socks[k] for k in readers])
    return out


def _rss_kib() -> dict:
    """This process's resident set in KiB: now (vmrss_kib) and at its
    peak (vmhwm_kib) from /proc/self/status, else now from
    /proc/self/statm; empty where neither says."""
    out = {}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                key, _, val = line.partition(":")
                if key in ("VmRSS", "VmHWM"):
                    out[f"{key.lower()}_kib"] = int(val.split()[0])
    except OSError:
        pass
    if "vmrss_kib" not in out:
        try:
            with open("/proc/self/statm") as f:
                pages = int(f.read().split()[1])
            out["vmrss_kib"] = pages * os.sysconf("SC_PAGE_SIZE") // 1024
        except (OSError, ValueError, IndexError):
            pass
    return out


def _worker_main(conn, lane_lo, lane_hi, words_per_lane, mb_w, mb_h,
                 pump_cpus):
    from espflix_tpu_torch.models.mpeg1_host import make_picture_batch
    from espflix_tpu_torch.ops.host_pack import pack_slice_rows, row_perm
    from espflix_tpu_torch.runtime.packed_gather import PackedGather
    from espflix_tpu_torch.runtime.player import PlayerSession

    n = lane_hi - lane_lo
    sessions = [None] * n
    aud_op = [None]
    pg = PackedGather(n, geometry=(mb_w * 16, mb_h * 16),
                      words_per_lane=words_per_lane, mb_w=mb_w, mb_h=mb_h,
                      log=None, cpus=pump_cpus)

    def attach(lane, url, kwargs) -> bool:
        s = PlayerSession(url, **kwargs)
        ok = s.init_service()
        sessions[lane - lane_lo] = s if ok else None
        return ok

    def gather(F):
        """One tick of this shard through the in-process Fleet's own
        gather (runtime/packed_gather.py; the classic gather where no
        lane is on the native fast path, as run_chunk_full falls back),
        its rows packed as run_chunk_full packs them, its events
        returned with fleet-wide lane numbers for the parent's event
        log."""
        t0 = time.perf_counter()
        ev_pic, ev_aud = [], []

        def logger(evs):
            def log(ev, lane=-1, value=0):
                evs.append((int(ev), lane_lo + lane, int(value)))
            return log
        pg.log, pg.counters = logger(ev_pic), {}
        g = pg.gather(sessions)
        if g is None:
            pics, pts, pre_errors = pg.pictures(sessions)
            b = make_picture_batch(pics, words_per_lane=words_per_lane,
                                   max_slices=mb_h, geometry=(mb_w, mb_h))
        else:
            b, pts, pre_errors = g
        video = b["active"].copy()
        n_i = int(((b["pic_type"] == 1) & video).sum())
        # per-LANE payload words; the [rows, win] windows gather on the
        # device
        sl = pack_slice_rows(b, sort_rows=True, device_windows=True)
        perm, dup = row_perm(sl["lane_of_row"], sl["rows"], sl["alive"],
                             n, mb_h)
        pre_errors |= dup | sl["overflow"]
        *audio, _ch, aud_op[0] = HG.gather_audio_arrays(
            sessions, F, aud_op[0], logger(ev_aud))
        return dict(
            x=CL.tick_inputs(sl, perm, b, {}, audio), pts=pts,
            pre_errors=pre_errors, video=video, n_i=n_i,
            aud_op=aud_op[0], ev_pic=ev_pic, ev_aud=ev_aud,
            feed=pg.counters, gather_s=time.perf_counter() - t0)

    def reply(op, obj):
        if op == "gather":
            _send_frame(conn.fileno(), obj)
        else:
            conn.send(obj)

    while True:
        try:
            msg = conn.recv()
        except (EOFError, KeyboardInterrupt):
            break
        op = msg[0]
        try:
            if op == "stop":
                conn.send(("ok", None))
                break
            elif op == "attach":
                _, lane, url, kwargs = msg
                conn.send(("ok", attach(lane, url, kwargs)))
            elif op == "attach_many":
                _, lanes, url, kwargs = msg
                conn.send(("ok", [attach(lane, url, kwargs)
                                  for lane in lanes]))
            elif op == "call":
                _, lane, method, args = msg
                s = sessions[lane - lane_lo]
                r = getattr(s, method)(*args) if s is not None else None
                conn.send(("ok", r))
            elif op == "state":
                _, lane = msg
                s = sessions[lane - lane_lo]
                conn.send(("ok", s.state.name if s else None))
            elif op == "states":
                conn.send(("ok", [s.state.name if s else None
                                  for s in sessions]))
            elif op == "gather":
                reply(op, ("ok", gather(msg[1])))
            elif op == "present":
                _, pts_ticks, err_ticks = msg
                out = []
                for pts_arr, err_arr in zip(pts_ticks, err_ticks):
                    resynced = []
                    for i, s in enumerate(sessions):
                        if s is None or pts_arr[i] < 0:
                            continue
                        s.on_presented(int(pts_arr[i]))
                        if err_arr[i] and s.resync():
                            resynced.append(lane_lo + i)
                    out.append(resynced)
                conn.send(("ok", out))
            elif op == "snapshot":
                conn.send(("ok", [s.snapshot() if s else None
                                  for s in sessions]))
            elif op == "restore":
                _, snaps = msg
                k = sum(bool(sessions[i].restore(sn))
                        for i, sn in enumerate(snaps)
                        if sn is not None and sessions[i] is not None)
                conn.send(("ok", k))
            elif op == "info":
                # what the worker process is: its pid, whether torch was
                # ever imported, the device mask it runs under, the CPUs
                # its pump's threads may take and its resident set now
                # and at its peak
                conn.send(("ok", dict(
                    pid=os.getpid(), torch="torch" in sys.modules,
                    cuda_visible=os.environ.get("CUDA_VISIBLE_DEVICES"),
                    pump_cpus=pump_cpus, **_rss_kib())))
            else:
                conn.send(("err", f"unknown op {op}"))
        except Exception as e:  # noqa: BLE001 - report, keep serving
            reply(op, ("err", f"{type(e).__name__}: {e}"))
    conn.close()


def _stop(procs, conns, socks):
    """Ask every worker to stop, then make sure each has exited."""
    for c in conns:
        try:
            c.send(("stop",))
        except (BrokenPipeError, OSError):
            pass
    for c in conns:
        try:
            c.recv()
        except (EOFError, OSError):
            pass
        c.close()
    for sk in socks:
        sk.close()
    for p in procs:
        try:
            p.wait(timeout=5)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


class HostPool:
    """W session workers over contiguous lane ranges.

    The worker count is the host-core knob (reference: one core per
    stream by construction; here lanes/W per core); each worker's native
    pump takes max(1, CPUs // W) threads of the CPUs this process may
    run on.  gather_tick() fans out and returns concatenated shard blobs
    for the device chain.  start_s is the wall time from the first
    worker's start until every worker answered.  Use as a context
    manager, or call close()."""

    def __init__(self, n_lanes: int, n_workers: int,
                 words_per_lane: int, mb_w: int, mb_h: int):
        assert n_lanes % n_workers == 0
        self.n = n_lanes
        self.w = n_workers
        self.ln = n_lanes // n_workers
        self.pump_cpus = max(1, len(os.sched_getaffinity(0)) // n_workers)
        # build the native libraries once here, not racing in W workers
        from espflix_tpu_torch.streaming import native, native_pump
        native.lib()
        native_pump.build()
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   PYTHONPATH=os.pathsep.join(
                       [str(_REPO)] + [p for p in os.environ.get(
                           "PYTHONPATH", "").split(os.pathsep) if p]))
        t0 = time.perf_counter()
        self.conns = []
        self.socks = []         # the same sockets, for the gather replies
        self.procs = []
        # each worker's receive buffer for its gather replies
        self._held = [[bytearray()] for _ in range(n_workers)]
        self._finalizer = weakref.finalize(self, _stop, self.procs,
                                           self.conns, self.socks)
        for k in range(n_workers):
            ours, theirs = socket.socketpair()
            theirs.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, _SNDBUF)
            p = subprocess.Popen(
                [sys.executable, "-m", "espflix_tpu_torch.runtime.hostpool",
                 str(theirs.fileno()), str(k * self.ln),
                 str((k + 1) * self.ln), str(words_per_lane), str(mb_w),
                 str(mb_h), str(self.pump_cpus)],
                pass_fds=(theirs.fileno(),), env=env, cwd=str(_REPO))
            theirs.close()
            self.conns.append(Connection(os.dup(ours.fileno())))
            self.socks.append(ours)
            self.procs.append(p)
        self.workers = [self._rpc(k, "info") for k in range(n_workers)]
        self.start_s = time.perf_counter() - t0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _rpc(self, k, *msg):
        self.conns[k].send(msg)
        return self._recv_ok(k)

    def _recv_ok(self, k):
        return self._ok(k, self.conns[k].recv())

    @staticmethod
    def _ok(k, reply):
        st, r = reply
        if st != "ok":
            raise RuntimeError(f"worker {k}: {r}")
        return r

    def _worker_of(self, lane):
        return lane // self.ln

    def attach(self, lane: int, url: str, **kwargs) -> bool:
        return self._rpc(self._worker_of(lane), "attach", lane, url,
                         kwargs)

    def attach_many(self, lanes, url: str, **kwargs) -> list[bool]:
        """attach() for every lane of `lanes`: one message per worker,
        the workers attaching their shares side by side.  Returns each
        lane's result, in the order of `lanes`."""
        lanes = [int(i) for i in lanes]
        mine = {}
        for i in lanes:
            mine.setdefault(self._worker_of(i), []).append(i)
        for k, ls in mine.items():
            self.conns[k].send(("attach_many", ls, url, kwargs))
        got = {}
        for k, ls in mine.items():
            got.update(zip(ls, self._recv_ok(k)))
        return [got[i] for i in lanes]

    def call(self, lane: int, method: str, *args):
        return self._rpc(self._worker_of(lane), "call", lane, method,
                         args)

    def state(self, lane: int):
        return self._rpc(self._worker_of(lane), "state", lane)

    def states(self) -> list:
        """Every lane's session state name (None where no session is
        attached), in lane order: one message per worker."""
        for c in self.conns:
            c.send(("states",))
        return [st for k in range(self.w) for st in self._recv_ok(k)]

    def info(self) -> list[dict]:
        """Each worker's pid, torch import flag, CUDA_VISIBLE_DEVICES,
        its pump's CPU share (pump_cpus) and resident set (vmrss_kib,
        vmhwm_kib), now."""
        for c in self.conns:
            c.send(("info",))
        return [self._recv_ok(k) for k in range(self.w)]

    def gather_tick(self, F: int, measure=None) -> dict:
        """Fan out one tick's gather; returns concatenated blobs in the
        pack_slice_rows_sharded layout (n_shards == n_workers).
        `measure` (Timers.measure-shaped) spans the wait for every reply,
        sends to the last reply unpickled (``pool_gather.wait``), and
        the join (``pool_gather.join``).  The result's "feed" holds the
        workers' feed counts and its "pool" the tick's pool counts:
        ``pool.worker_us`` (the slowest worker's own gather),
        ``pool.worker_us_sum`` (every worker's), ``pool.reply_bytes``
        (the pickled replies' bytes) and ``pool.ticks`` (1)."""
        span = measure or HG.no_span
        with span("pool_gather.wait"):
            for c in self.conns:
                c.send(("gather", F))
            got = _recv_frames(self.socks, self._held)
            nbytes = sum(n for _r, n in got)
            parts = [self._ok(k, r) for k, (r, _n) in enumerate(got)]
        with span("pool_gather.join"):
            out = CL.join_workers([p["x"] for p in parts])
            for k in ("pts", "pre_errors", "video"):
                out[k] = np.concatenate([p[k] for p in parts])
        out["n_i"] = sum(p["n_i"] for p in parts)
        # events in the in-process order: every lane's picture events,
        # then every lane's audio events
        out["ev_pic"] = [e for p in parts for e in p["ev_pic"]]
        out["ev_aud"] = [e for p in parts for e in p["ev_aud"]]
        ops = [p["aud_op"] for p in parts if p["aud_op"]]
        out["aud_op"] = ops[0] if ops else None
        # the shards' feed counts (the gather's tally); they pump side by
        # side, so the tick's rounds are the most any worker made
        names = {k for p in parts for k in p["feed"]}
        out["feed"] = {k: sum(p["feed"].get(k, 0) for p in parts)
                       for k in names}
        out["feed"]["feed.rounds"] = max(p["feed"].get("feed.rounds", 0)
                                         for p in parts)
        worker_s = [p["gather_s"] for p in parts]
        out["pool"] = {"pool.worker_us": int(1e6 * max(worker_s)),
                       "pool.worker_us_sum": int(1e6 * sum(worker_s)),
                       "pool.reply_bytes": nbytes, "pool.ticks": 1}
        return out

    def present(self, pts, errors) -> list[list[int]]:
        """Route a chunk's presentation to the workers, one message a
        worker: tick by tick (pts, errors: [ticks, lanes]), every lane
        with a picture (pts >= 0) presents it, and re-seeks where
        `errors` flags it.  Returns each tick's lanes that re-seeked,
        in lane order."""
        pts, errors = np.asarray(pts), np.asarray(errors)
        for k, c in enumerate(self.conns):
            c.send(("present", pts[:, k * self.ln:(k + 1) * self.ln],
                    errors[:, k * self.ln:(k + 1) * self.ln]))
        got = [self._recv_ok(k) for k in range(self.w)]
        return [[i for g in got for i in g[t]] for t in range(len(pts))]

    def snapshot(self) -> list:
        for c in self.conns:
            c.send(("snapshot",))
        out = []
        for k in range(self.w):
            out.extend(self._recv_ok(k))
        return out

    def restore(self, snaps: list) -> int:
        for k, c in enumerate(self.conns):
            c.send(("restore", snaps[k * self.ln:(k + 1) * self.ln]))
        return sum(self._recv_ok(k) for k in range(self.w))

    def close(self):
        """Stop the workers (idempotent)."""
        self._finalizer()


if __name__ == "__main__":
    # a worker: fd of its socket, then its lane range, geometry and the
    # CPUs its pump's threads may take
    fd, *rest = (int(a) for a in sys.argv[1:])
    _worker_main(Connection(fd), *rest)
