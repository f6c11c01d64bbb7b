"""Entry `pooled`: the served path with the sessions in host worker
processes.

The served entry's cell (entries/served.py: its service, plays, window,
release and checks) with every lane's PlayerSession in a HostPool of
the configuration's `host.workers` worker processes over contiguous
lane ranges (runtime/hostpool.py), each of which gathers its lanes
through the program's own gather and ships them to this process, which
joins the shards and runs the chain: the window calls
`Fleet.run_chunk_full_pooled` in chunks of `ticks_per_chunk` ticks,
closed loop.  Set-up attaches every lane with one message a worker
(`HostPool.attach_many`) and starts each on its seeded title and GOP
through `PlayerSession.restore` in the workers (`HostPool.restore`); a
lane whose title ends moves to its next seeded title from the start
between chunks, found through `HostPool.states`.  A tick's latency runs
from the start of its `pool_gather` span to the return of its chunk.
The SBC record the checks read comes from each tick's joined shards
(`HostPool.gather_tick`'s audio arrays).

Checked as the served cell is, against the same reference, and:

- `workers`: the workers that imported torch, saw a card
  (CUDA_VISIBLE_DEVICES not empty) or had exited before `release`
  (`HostPool.info`).

`release` closes the pool, as does a failed set-up; a program whose
HostPool has no `attach_many` cannot run the cell, and set-up stops at
once, before any worker starts.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np

from espflix_tpu_torch.runtime.hostpool import HostPool
from espflix_tpu_torch.runtime.scheduler import Fleet

from espbench import workload
from espbench.entries import served as S


class PooledFleet(Fleet):
    """A Fleet whose full-chain chunks run on its HostPool `pool`."""

    pool = None

    def run_chunk_full(self, n_ticks: int, tap_lanes=()):
        return self.run_chunk_full_pooled(self.pool, n_ticks,
                                          tap_lanes=tap_lanes)


class Cell(S.Cell):
    """One run of a pooled cell (see the module's docstring)."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device,
                 trace: bool):
        if not hasattr(HostPool, "attach_many"):
            raise RuntimeError("the program has no HostPool.attach_many: "
                               "it cannot serve pooled sessions")
        self.cfg, self.mix, self.device = cfg, mix, device
        self.pal = cfg["standard"] == "pal"
        self.K = mix["ticks_per_chunk"]
        self.per = S.PTS_HZ // cfg["tick_hz"]
        self.gop = cfg["video"]["gop"]
        self.root = tempfile.mkdtemp(prefix="espbench-service-")
        self.pool = None
        try:
            self._set_up(seed)
        except BaseException:
            self._close_pool()
            shutil.rmtree(self.root, ignore_errors=True)
            raise

    def _set_up(self, seed: int):
        cfg, mix = self.cfg, self.mix
        self.t = t = workload.sessions(seed, cfg, mix, self.root)
        self.tap = [int(i) for i in t.checked]
        with open(os.path.join(self.root, "manifest.txt")) as f:
            self.names = [x for x in f.read().splitlines() if x]
        self.fleet = f = PooledFleet(
            t.lanes, words_per_lane=mix["words_per_lane"],
            tick_rate=cfg["tick_hz"], parser="pallas", output=True,
            pal=self.pal, device=self.device)
        f.timers = S.SpanTimers()
        self.pool = f.pool = pool = HostPool(
            t.lanes, cfg["host"]["workers"], mix["words_per_lane"], f.mb_w,
            f.mb_h)
        self.audio_log = []
        gather = pool.gather_tick

        def gather_tick(F, measure=None):
            g = gather(F, measure)
            self.audio_log.append((g["aud_words"][self.tap].copy(),
                                   g["aud_act"].copy(), g["aud_nval"].copy(),
                                   g["starved"].copy()))
            return g
        pool.gather_tick = gather_tick
        # the harness's record of each lane's plays: [(chunk, title, gop)]
        self.plays = [[] for _ in range(t.lanes)]
        self.hops = np.zeros(t.lanes, np.int64)
        self.chunk_no = 0
        if not all(pool.attach_many(range(t.lanes), "file://" + self.root,
                                    pal=self.pal)):
            raise RuntimeError("the service did not load")
        if pool.restore([self._start(i, int(t.first_title[i]),
                                     int(t.first_gop[i]))
                         for i in range(t.lanes)]) != t.lanes:
            raise RuntimeError("a lane did not start its play")
        self.chunks = []        # per chunk: (title[lanes], pts, presented)
        self.flagged = 0        # lane-ticks with an error flag, every chunk
        self.audio_recs = {}
        self.warm = self._run()[0]
        for _ in range(mix["warm_chunks"] - 1):
            self._run()

    def _start(self, i: int, title: int, gop: int) -> dict:
        """Record lane i's play of `title` from `gop`; the session state
        that starts it (PlayerSession.restore: nav, the position, play),
        as the served entry's nav, position and play_pause do."""
        self.plays[i].append((self.chunk_no, title, gop))
        return dict(title=self.names[title], pos=gop * self.gop * self.per,
                    speed=0, state="PLAYING")

    def _renavigate(self):
        t = self.t
        snaps = [None] * t.lanes
        for i, state in enumerate(self.pool.states()):
            if state == "DONE":
                title = int(t.next_titles[i, self.hops[i] % t.next_titles
                                          .shape[1]])
                self.hops[i] += 1
                snaps[i] = self._start(i, title, 0)
        if any(s is not None for s in snaps):
            self.pool.restore(snaps)

    def _run(self):
        """One chunk: (results, tick start times, end time); a tick
        starts at its `pool_gather` span."""
        n0 = len(self.fleet.timers.spans)
        rs, _starts, end = super()._run()
        starts = [s for name, s, _e in self.fleet.timers.spans[n0:]
                  if name == "pool_gather"]
        return rs, starts, end

    def _close_pool(self) -> int:
        """Close the pool; the workers that imported torch, saw a card or
        had exited by then."""
        pool, self.pool = self.pool, None
        if pool is None:
            return 0
        try:
            bad = sum(p.poll() is not None for p in pool.procs)
            if not bad:
                bad = sum(w["torch"] or w["cuda_visible"] != ""
                          for w in pool.info())
        except (EOFError, OSError, RuntimeError):
            bad = pool.w        # a worker did not answer
        finally:
            pool.close()
        return bad

    def release(self):
        self.bad_workers = self._close_pool()
        self.fleet.pool = None
        super().release()

    def check(self) -> dict:
        out = super().check()
        out["workers"] = (self.bad_workers, 0)
        return out
