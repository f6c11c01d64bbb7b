"""The served gather: one tick of pictures from a lane range, popped
straight into the batch layout.

The in-process Fleet (``Fleet._gather_batch_packed``,
runtime/scheduler.py) and every HostPool worker (runtime/hostpool.py)
gather through a ``PackedGather``: it holds the lanes' persistent batch
buffers (streaming/native_feed.PackedBatch), their title mappings
(streaming/title_maps.TitleMaps), the geometry and size policy
(runtime/host_gather.admit and ``fits``), the event log it reports to,
the span function it times its parts with and the counters it adds the
tick's ``feed.*`` counts to.  ``gather`` is the packed gather;
``pictures`` the classic one (runtime/host_gather.gather_pictures),
which hands the mapped lanes' cursors back to their Streamers first.

Torch-free: the workers import this module and never torch.
"""

from __future__ import annotations

import numpy as np

from espflix_tpu_torch.runtime import host_gather as HG
from espflix_tpu_torch.runtime.player import READ_CHUNK, PlayerSession, \
    State
from espflix_tpu_torch.streaming import native_feed as NF
from espflix_tpu_torch.streaming import native_pump as NP
from espflix_tpu_torch.streaming import title_maps as TMAP

MAX_PUMPS = 64                  # PlayerSession.next_picture's max_pumps
_TRICK_STATES = (State.FAST_FORWARD, State.REWIND)


def _pump_patched(s) -> bool:
    """Whether a session's pump() is overridden (subclass or patch)."""
    return "pump" in s.__dict__ or type(s).pump is not PlayerSession.pump


class PackedGather:
    """The gather of `n` lanes of `geometry` (pixels) into rows of
    `words_per_lane` words and at most `mb_h` slices.  `log` is an
    EventLog.log-shaped callable (lanes numbered within the sessions
    gathered), `measure` a Timers.measure-shaped span function, or
    None, `counters` the dict the tick's ``feed.*`` counts are added to;
    each may be replaced between ticks.  `cpus` caps the native pump's
    threads (None: every CPU this process may run on)."""

    def __init__(self, n: int, *, geometry: tuple[int, int],
                 words_per_lane: int, mb_w: int, mb_h: int, log,
                 measure=None, counters: dict | None = None,
                 cpus: int | None = None):
        self.n = n
        self.width, self.height = geometry
        self.words_per_lane = words_per_lane
        self.mb_w, self.mb_h = mb_w, mb_h
        self.log = log
        self.measure = measure
        self.counters = {} if counters is None else counters
        self.cpus = cpus
        self.packed = None        # NF.PackedBatch, made on first need
        self.titles = None        # TMAP.TitleMaps, made with it

    def admit(self, i, s, width: int, height: int, payload_len: int,
              n_slices: int, pre_errors) -> bool:
        """host_gather.admit for this gather's geometry and capacity."""
        return HG.admit(self.log, i, s, width, height, payload_len,
                        n_slices, geometry=(self.width, self.height),
                        words_per_lane=self.words_per_lane,
                        max_slices=self.mb_h, pre_errors=pre_errors)

    def pictures(self, sessions):
        """The classic gather (host_gather.gather_pictures): (pictures,
        pts, pre_errors)."""
        if self.titles is not None:
            # the sessions' Streamers read again: hand the cursors back
            self.titles.release()
        return HG.gather_pictures(
            sessions, self.log, geometry=(self.width, self.height),
            words_per_lane=self.words_per_lane, max_slices=self.mb_h,
            tally=self.counters, measure=self.measure)

    def _ensure_packed(self):
        if self.packed is None:
            self.packed = NF.PackedBatch(self.n, self.words_per_lane,
                                         self.mb_h, self.mb_w, self.mb_h)
            self.titles = TMAP.TitleMaps(self.n, READ_CHUNK)
        return self.packed

    def gather(self, sessions):
        """The packed twin of ``pictures`` + make_picture_batch
        (scheduler.py:386-565): one sf_pop_pictures_packed call per pump
        round writes every popped payload straight into the persistent
        batch buffers (EOS pad, byteswap and stale-row zeroing in C++),
        one sf_feed_many call feeds the lanes that pumped.  Pictures the
        policies must see (rejected by geometry or size, popped through
        the growable per-lane path, or from lanes off the fast path) are
        checked after the rounds in lane order, so the events come out
        as ``pictures`` logs them.  Returns (batch_dict, pts,
        pre_errors), or None when the native feed is not built or no
        lane is on the fast path (the caller falls back to
        ``pictures``).

        A fast lane whose pump is not overridden and whose Streamer has
        a regular file open reads from a read-only mapping of that file
        (streaming/title_maps.py; titles are immutable while served),
        checked once a tick.  Those lanes run their pump rounds in ONE
        threaded native call (streaming/native_pump.py, span
        "gather.pop"): pops, mapped reads and feeds, each lane on its
        own, stopping at a picture, a capacity rc or its title's end;
        the results then take the same vectorised path as a round's
        pops.  The other lanes read through their Streamer or their
        patched pump, round by round: each round spans its pop
        ("gather.pop"), the Python reads ("gather.read", which also
        holds the tick's attach check and the EOS branch of lanes at
        their end) and the feed call ("gather.feed").  The tick's feed
        counts go to `counters`; ``feed.rounds`` is the most pops a
        lane made."""
        if not NF.available():
            return None
        fast, slow = HG.fast_lanes(sessions)
        if not fast:
            if self.titles is not None:
                self.titles.release()
            return None
        span = self.measure or HG.no_span
        n_slow = sum(s.state in HG.PUMP_STATES for _, s in slow)
        playing = len(fast) + n_slow
        trick = sum(s.state in _TRICK_STATES for _, s in fast + slow)
        n_read = n_mapped = rounds = 0
        pb = self._ensure_packed()
        tm = self.titles
        with span("gather.read"):
            mapped = [(i, s) for i, s in fast
                      if not (s.eos or _pump_patched(s))]
            attached = tm.sync([i for i, _ in mapped],
                               [s.streamer for _, s in mapped],
                               [s.feed._lane for _, s in mapped])
        for s in sessions:
            if s is not None:
                s.clock.tick()
        pb.begin_tick()
        pre_errors = np.zeros(self.n, bool)
        # (lane, session, width, height, payload bytes, slices, picture
        # to merge or None when the native pop already consumed it)
        checks = []
        on_map = tm.src[[i for i, _ in fast]] >= 0
        native = [fast[k] for k in np.flatnonzero(on_map)]
        pending = [fast[k] for k in np.flatnonzero(~on_map)]
        if native:
            # the lanes on a title mapping: ONE threaded native call runs
            # each one's pump rounds (streaming/native_pump.py)
            slots_n = np.fromiter((i for i, _ in native), np.int32,
                                  len(native))
            with span("gather.pop"):
                r = NP.get_pump().run(pb, tm, slots_n, MAX_PUMPS,
                                      cpus=self.cpus)
            rounds = int(r.rounds.max())
            n_read = n_mapped = int(r.fed.sum())
            self._take_pops(pb, native, slots_n,
                            tm.nlane[slots_n].astype(np.int64), r.rc,
                            r.meta, r.iq8, r.nq8, checks)
            ends = np.flatnonzero(r.ended)
            if len(ends):
                # lanes at their title's end: the EOS branch
                with span("gather.read"):
                    for k in ends:
                        i, s = native[k]
                        s.feed.eos()
                        s.eos = True
                        self._last_pop(i, s, checks)
        for py_rounds in range(1, MAX_PUMPS + 1):
            if not pending:
                break
            rounds = max(rounds, py_rounds)
            feeds = [s.feed for _, s in pending]
            slots = [i for i, _ in pending]
            with span("gather.pop"):
                rc, meta, iq8, nq8 = NF.pop_many_packed(pb, feeds, slots)
            self._take_pops(pb, pending, np.asarray(slots, np.int32),
                            np.fromiter((f._lane for f in feeds), np.int64,
                                        len(feeds)),
                            rc, meta, iq8, nq8, checks)
            keep = np.zeros(len(pending), bool)   # pumped: pop again
            # one streamer read per starved lane; a patched pump() stays
            # the per-lane override point
            bat_f, bat_d = [], []
            with span("gather.read"):
                for k in np.flatnonzero(rc == 0):
                    i, s = pending[k]
                    if _pump_patched(s):
                        b0 = s.bytes_read
                        pumped = s.pump()
                        n_read += s.bytes_read - b0
                        if pumped:
                            keep[k] = True
                            continue
                    elif not s.eos:
                        data = s.streamer.read(READ_CHUNK)
                        if data:
                            bat_f.append(s.feed)
                            bat_d.append(data)
                            keep[k] = True
                            continue
                        s.feed.eos()
                        s.eos = True
                    self._last_pop(i, s, checks)
            # ONE native feed call for the round (sf_feed_many)
            with span("gather.feed"):
                NF.feed_many(bat_f, bat_d)
            n_read += sum(map(len, bat_d))
            pending = [pending[k] for k in np.flatnonzero(keep)]
        read0 = HG.read_total(s for _, s in slow)
        for i, s in slow:
            p = s.next_picture()
            if p is not None:
                checks.append(self._check_of(i, s, p))
        n_read += HG.read_total(s for _, s in slow) - read0
        for i, s, w, h, plen, nsl, p in sorted(checks, key=lambda c: c[0]):
            if self.admit(i, s, w, h, plen, nsl, pre_errors) \
                    and p is not None:
                pb.merge_picture(i, p)
        HG.add_counts(self.counters, {
            "feed.bytes_read": n_read, "feed.mapped_bytes": n_mapped,
            "feed.rounds": rounds, "feed.lane_ticks": playing,
            "feed.underruns": playing - int(pb.active.sum()),
            "feed.trick_lane_ticks": trick, "feed.slow_lane_ticks": n_slow,
            "feed.attaches": attached})
        return pb.batch_dict(), pb.pts.copy(), pre_errors

    def _take_pops(self, pb, lanes, slots_a, nlanes, rc, meta, iq8, nq8,
                   checks):
        """The packed pops' results for `lanes` ((lane, session) at
        slots `slots_a`, native feed lanes `nlanes`): rc 1 with geometry
        and capacity in bounds goes to pb's vectors at once; a picture
        rejected, or one the packed pop could not hold (rc < 0, popped
        here through the growable per-lane path), goes to `checks`."""
        got = rc == 1
        if got.any():
            assert (meta[got, NF.M_WIDTH] > 0).all(), \
                "picture before sequence header"
            okg = ((meta[:, NF.M_WIDTH] == self.width)
                   & (meta[:, NF.M_HEIGHT] == self.height))
            okc = HG.fits(meta[:, NF.M_PAYLOAD_LEN], meta[:, NF.M_NSLICES],
                          self.words_per_lane, self.mb_h)
            good = got & okg & okc
            keys = (nlanes << 44) | meta[:, NF.M_SEQ_COUNTER]
            for k in np.flatnonzero(good & (pb.qkey[slots_a] != keys)):
                m = meta[k]
                pb.set_queues(int(slots_a[k]), lanes[k][1].feed,
                              bool(m[NF.M_HAS_IQ]), bool(m[NF.M_HAS_NQ]),
                              iq8[k], nq8[k], int(m[NF.M_SEQ_COUNTER]),
                              qkey=int(keys[k]))
            si = slots_a[good]
            pb.pic_type[si] = meta[good, NF.M_PTYPE]
            pb.full_pel[si] = meta[good, NF.M_FULL_PEL]
            pb.r_size[si] = np.maximum(meta[good, NF.M_R_SIZE], 0)
            pb.n_slices[si] = meta[good, NF.M_NSLICES]
            pb.active[si] = True
            pb.pts[si] = meta[good, NF.M_PTS]
            for k in np.flatnonzero(got & ~(okg & okc)):
                # consumed but rejected: the row holds its words, the
                # lane stays inactive as in make_picture_batch
                m = meta[k]
                i = int(slots_a[k])
                pb.n_words[i] = 0
                checks.append((i, lanes[k][1], int(m[NF.M_WIDTH]),
                               int(m[NF.M_HEIGHT]),
                               int(m[NF.M_PAYLOAD_LEN]),
                               int(m[NF.M_NSLICES]), None))
        for k in np.flatnonzero(rc < 0):
            # capacity: the picture was NOT consumed; pop it through the
            # growable per-lane path
            i, s = lanes[k]
            p = s.feed.pop_picture()
            if p is not None:
                checks.append(self._check_of(i, s, p))

    def _last_pop(self, i, s, checks):
        """A lane that pumped nothing: its last picture to check, or
        DONE with its position saved (next_picture's EOS branch)."""
        p = s.feed.pop_picture()
        if p is None:
            s.state = State.DONE
            s.save_pos(False)
        else:
            checks.append(self._check_of(i, s, p))

    @staticmethod
    def _check_of(i, s, p):
        return (i, s, p.seq.width, p.seq.height, len(p.payload),
                len(p.slice_offsets), p)
