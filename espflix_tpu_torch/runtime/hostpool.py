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
runtime/host_gather.py, runtime/chunk_layout.py, runtime/player.py and
the session feeds).  It gathers through the in-process Fleet's own
functions (runtime/host_gather.py), so it admits, drops and re-seeks
pictures as the Fleet does, and returns the events it would have
logged.  Parent and worker talk through a multiprocessing Connection
over a socket pair.  Control actions (seek/pause/trick) and
snapshot/restore route to workers as messages and apply between ticks
-- the same boundary semantics as the chunked dispatch.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
import weakref
from multiprocessing.connection import Connection
from pathlib import Path

import numpy as np

from espflix_tpu_torch.runtime import chunk_layout as CL

__all__ = ["HostPool"]

_REPO = Path(__file__).resolve().parent.parent.parent


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


def _worker_main(conn, lane_lo, lane_hi, words_per_lane, mb_w, mb_h):
    from espflix_tpu_torch.models.mpeg1_host import make_picture_batch
    from espflix_tpu_torch.ops.host_pack import pack_slice_rows, row_perm
    from espflix_tpu_torch.runtime import host_gather as HG
    from espflix_tpu_torch.runtime.player import PlayerSession

    n = lane_hi - lane_lo
    sessions = [None] * n
    aud_op = [None]

    def gather(F):
        """One tick of this shard through the Fleet's own gather
        (runtime/host_gather.py), its events returned with fleet-wide
        lane numbers for the parent's event log."""
        t0 = time.perf_counter()
        ev_pic, ev_aud = [], []

        def logger(evs):
            def log(ev, lane=-1, value=0):
                evs.append((int(ev), lane_lo + lane, int(value)))
            return log
        feed = {}
        pics, pts, pre_errors = HG.gather_pictures(
            sessions, logger(ev_pic), geometry=(mb_w * 16, mb_h * 16),
            words_per_lane=words_per_lane, max_slices=mb_h, tally=feed)
        n_i = sum(p is not None and p.pic_type == 1 for p in pics)
        b = make_picture_batch(pics, words_per_lane=words_per_lane,
                               max_slices=mb_h, geometry=(mb_w, mb_h))
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
            pre_errors=pre_errors,
            video=np.array([p is not None for p in pics]), n_i=n_i,
            aud_op=aud_op[0], ev_pic=ev_pic, ev_aud=ev_aud, feed=feed,
            gather_s=time.perf_counter() - t0)

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
                s = PlayerSession(url, **kwargs)
                ok = s.init_service()
                sessions[lane - lane_lo] = s if ok else None
                conn.send(("ok", ok))
            elif op == "call":
                _, lane, method, args = msg
                s = sessions[lane - lane_lo]
                r = getattr(s, method)(*args) if s is not None else None
                conn.send(("ok", r))
            elif op == "state":
                _, lane = msg
                s = sessions[lane - lane_lo]
                conn.send(("ok", s.state.name if s else None))
            elif op == "gather":
                conn.send(("ok", gather(msg[1])))
            elif op == "present":
                _, pts_arr, err_arr = msg
                resynced = []
                for i, s in enumerate(sessions):
                    if s is None or pts_arr[i] < 0:
                        continue
                    s.on_presented(int(pts_arr[i]))
                    if err_arr[i] and s.resync():
                        resynced.append(lane_lo + i)
                conn.send(("ok", resynced))
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
                # ever imported, the device mask it runs under and its
                # resident set now and at its peak
                conn.send(("ok", dict(
                    pid=os.getpid(), torch="torch" in sys.modules,
                    cuda_visible=os.environ.get("CUDA_VISIBLE_DEVICES"),
                    **_rss_kib())))
            else:
                conn.send(("err", f"unknown op {op}"))
        except Exception as e:  # noqa: BLE001 - report, keep serving
            conn.send(("err", f"{type(e).__name__}: {e}"))
    conn.close()


def _stop(procs, conns):
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
    for p in procs:
        try:
            p.wait(timeout=5)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


class HostPool:
    """W session workers over contiguous lane ranges.

    The worker count is the host-core knob (reference: one core per
    stream by construction; here lanes/W per core).  gather_tick() fans
    out and returns concatenated shard blobs for the device chain.
    start_s is the wall time from the first worker's start until every
    worker answered; `timing` sums, over gather_tick calls, the slowest
    worker's own gather (worker_s), the parent's wait for all replies,
    unpickling included (wait_s), and its concatenation (concat_s).
    Use as a context manager, or call close()."""

    def __init__(self, n_lanes: int, n_workers: int,
                 words_per_lane: int, mb_w: int, mb_h: int):
        assert n_lanes % n_workers == 0
        self.n = n_lanes
        self.w = n_workers
        self.ln = n_lanes // n_workers
        # build the native libraries once here, not racing in W workers
        from espflix_tpu_torch.streaming import native
        native.lib()
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   PYTHONPATH=os.pathsep.join(
                       [str(_REPO)] + [p for p in os.environ.get(
                           "PYTHONPATH", "").split(os.pathsep) if p]))
        t0 = time.perf_counter()
        self.conns = []
        self.procs = []
        for k in range(n_workers):
            ours, theirs = socket.socketpair()
            p = subprocess.Popen(
                [sys.executable, "-m", "espflix_tpu_torch.runtime.hostpool",
                 str(theirs.fileno()), str(k * self.ln),
                 str((k + 1) * self.ln), str(words_per_lane), str(mb_w),
                 str(mb_h)],
                pass_fds=(theirs.fileno(),), env=env, cwd=str(_REPO))
            theirs.close()
            self.conns.append(Connection(ours.detach()))
            self.procs.append(p)
        self._finalizer = weakref.finalize(self, _stop, self.procs,
                                           self.conns)
        self.workers = [self._rpc(k, "info") for k in range(n_workers)]
        self.start_s = time.perf_counter() - t0
        self.timing = dict(ticks=0, worker_s=0.0, wait_s=0.0, concat_s=0.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _rpc(self, k, *msg):
        self.conns[k].send(msg)
        return self._recv_ok(k)

    def _recv_ok(self, k):
        st, r = self.conns[k].recv()
        if st != "ok":
            raise RuntimeError(f"worker {k}: {r}")
        return r

    def _worker_of(self, lane):
        return lane // self.ln

    def attach(self, lane: int, url: str, **kwargs) -> bool:
        return self._rpc(self._worker_of(lane), "attach", lane, url,
                         kwargs)

    def call(self, lane: int, method: str, *args):
        return self._rpc(self._worker_of(lane), "call", lane, method,
                         args)

    def state(self, lane: int):
        return self._rpc(self._worker_of(lane), "state", lane)

    def info(self) -> list[dict]:
        """Each worker's pid, torch import flag, CUDA_VISIBLE_DEVICES
        and resident set (vmrss_kib, vmhwm_kib), now."""
        for c in self.conns:
            c.send(("info",))
        return [self._recv_ok(k) for k in range(self.w)]

    def gather_tick(self, F: int) -> dict:
        """Fan out one tick's gather; returns concatenated blobs in the
        pack_slice_rows_sharded layout (n_shards == n_workers)."""
        t0 = time.perf_counter()
        for c in self.conns:
            c.send(("gather", F))
        parts = [self._recv_ok(k) for k in range(self.w)]
        t1 = time.perf_counter()
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
        # the shards' feed counts (host_gather.gather_pictures' tally);
        # they pump side by side, so the tick's rounds are the most any
        # worker made
        out["feed"] = {k: sum(p["feed"][k] for p in parts)
                       for k in parts[0]["feed"]}
        out["feed"]["feed.rounds"] = max(p["feed"]["feed.rounds"]
                                         for p in parts)
        tm = self.timing
        tm["ticks"] += 1
        tm["worker_s"] += max(p["gather_s"] for p in parts)
        tm["wait_s"] += t1 - t0
        tm["concat_s"] += time.perf_counter() - t1
        return out

    def present(self, pts, errors) -> list[int]:
        """Route one tick's presentation to the workers: every lane with
        a picture (pts >= 0) presents it, and re-seeks where `errors`
        flags it.  Returns the lanes that re-seeked, in lane order."""
        for k, c in enumerate(self.conns):
            c.send(("present", pts[k * self.ln:(k + 1) * self.ln],
                    errors[k * self.ln:(k + 1) * self.ln]))
        return [i for k in range(self.w) for i in self._recv_ok(k)]

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
    # a worker: fd of its socket, then its lane range and geometry
    fd, *rest = (int(a) for a in sys.argv[1:])
    _worker_main(Connection(fd), *rest)
