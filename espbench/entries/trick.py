"""Entry `trick`: the served path under the remote's keys.

The served entry's cell (entries/served.py) on a service whose titles
carry upstream-shaped trick streams (content/trick.py), with the
remote's keys applied between chunks through `Fleet.apply_keys`, which
dispatches each to its lane's session as the remote does.  The mix's
`trick_lanes` lanes cycle through RIGHT (fast-forward) for `ff_ticks`,
PLAY for `play_ticks`, LEFT (rewind) for `ff_ticks` and PLAY for
`play_ticks`, each at a seeded chunk phase (a lane whose phase falls in
a fast-forward or rewind stretch starts it before the first chunk); its
`skip_lanes` lanes press UP or DOWN (seeded, even odds) once a
`skip_every_ticks` ticks at a seeded chunk phase; the others play
straight.  A key is sent only where
it does what the schedule means: RIGHT and LEFT to a playing lane, PLAY
to a fast-forwarding or rewinding lane, UP and DOWN to a playing lane.
A lane whose stream ends (its title's end, fast-forward past the end,
rewind past the start) moves to its next seeded title from the start,
as in the served cell.  A program without `Fleet.apply_keys` cannot run
the cell: set-up stops at once.

Checked after the window, besides everything the served entry checks
(planes, field checksums and tapped fields of the warm and last chunks,
now of the trick pictures too; tapped SBC frames, PDM and its carry;
error flags), against reference/trick.py following every lane's player
on its own from its starts, the keys and the ends:

- `pts`: a presented picture that is not the next of its lane's play;
- `landing`: a play's first presented picture that is not the picture
  of the packet the index gives for that seek;
- `ends`: a play the program ended (its lane moved on) where the
  reference's had not reached its stream's end and a tick past it, or
  the reverse;
- `keys`: a key sent that did nothing in the reference;
- `trick_sbc`: SBC frames a tapped lane popped while fast-forwarding or
  rewinding (the trick streams carry none).

The tapped lanes' PDM is checked from the SBC history each lane's last
popped frame leaves (the decoder keeps it through trick play and
seeks), so a lane that began a play in the chunk is checked too.
"""

from __future__ import annotations

import tempfile

import numpy as np
import torch

from espflix_tpu_torch.runtime.player import PlayerSession
from espflix_tpu_torch.runtime.scheduler import Fleet

from espbench.content import trick as content
from espbench.entries import served as S
from espbench.reference import audio as RA
from espbench.reference import media
from espbench.reference import trick as RT

KEY_SPEED = {RT.KEY_RIGHT: 1, RT.KEY_LEFT: -1, RT.KEY_PLAY: 0,
             RT.KEY_UP: 0, RT.KEY_DOWN: 0}


class Cell(S.Cell):
    """One run of a trick cell (see the module's docstring)."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device,
                 trace: bool):
        if not hasattr(Fleet, "apply_keys"):
            raise RuntimeError("the program has no Fleet.apply_keys: it "
                               "cannot run the remote's keys")
        self.cfg, self.mix, self.device = cfg, mix, device
        self.pal = cfg["standard"] == "pal"
        self.K = K = mix["ticks_per_chunk"]
        self.per = S.PTS_HZ // cfg["tick_hz"]
        self.gop = cfg["video"]["gop"]
        self.root = tempfile.mkdtemp(prefix="espbench-service-")
        self.t = t = content.sessions(seed, cfg, mix, self.root)
        if t.period % t.trick_period:
            raise ValueError("a trick stream's period does not divide the "
                             "main stream's")
        self.titles = [RT.Title(f["video.idx"], {
            0: f["video.ts"], 1: f["video_fwd.ts"], -1: f["video_rwd.ts"]})
            for f in t.files]
        t.files = None
        self.ff, self.pl = mix["ff_ticks"] // K, mix["play_ticks"] // K
        self.skip_every = mix["skip_every_ticks"] // K
        self.tap = [int(i) for i in t.checked]
        self.fleet = f = Fleet(t.lanes, words_per_lane=mix["words_per_lane"],
                               tick_rate=cfg["tick_hz"], parser="pallas",
                               output=True, pal=self.pal, device=device,
                               audio_frames_per_tick=cfg["frames_per_tick"])
        f.timers = S.SpanTimers()
        self.audio_log = []
        gather = f._gather_audio_arrays

        def gather_audio(F):
            out = gather(F)
            words, act, nval, starved, _ch = out
            self.audio_log.append((words[self.tap].copy(), act.copy(),
                                   nval.copy(), starved.copy()))
            return out
        f._gather_audio_arrays = gather_audio
        self.plays = [[] for _ in range(t.lanes)]
        self.hops = np.zeros(t.lanes, np.int64)
        self.chunk_no = 0
        # the stream each lane plays (-1, 0, 1), as the keys sent leave it
        self.speed = np.zeros(t.lanes, np.int64)
        self.keys = {}          # chunk -> [(lane, key)] sent before it
        self.speeds = []        # per chunk, each lane's stream in it
        url = "file://" + self.root
        shift = np.zeros(t.lanes, np.int64)
        shift[t.trick] = [self.cycle_shift(int(p) * K)
                          for p in t.trick_phase]
        for i in range(t.lanes):
            s = PlayerSession(url, pal=self.pal)
            if not s.init_service():
                raise RuntimeError("the service did not load")
            self._start(i, s, int(t.first_title[i]), int(t.first_gop[i]),
                        int(shift[i]))
            f.attach(i, s)
        self.chunks = []
        self.flagged = 0
        self.audio_recs = {}
        self.warm = self._run()[0]
        for _ in range(mix["warm_chunks"] - 1):
            self._run()

    def _start(self, i: int, s: PlayerSession, title: int, gop: int,
               shift: int = 0):
        """Play `title` from its GOP `gop` start plus `shift` PTS ticks
        (the saved position the player's index seek starts from); the
        plays are recorded as (chunk, title, position)."""
        s.nav(title)
        s.info[title].pos = pos = gop * self.gop * self.per + shift
        s.play_pause()
        self.plays[i].append((self.chunk_no, title, pos))
        self.speed[i] = 0

    def cycle_shift(self, ticks: int) -> int:
        """How far (PTS ticks of the main stream) a trick lane's cycle
        has carried it `ticks` ticks after its fast-forward began: 15
        pictures a tick forward, one a tick in play, 15 back.  A trick
        lane starts at its seeded GOP plus the shift of its phase, where
        its cycle would have brought it, so the cell runs its steady
        state from the first tick."""
        ff, pl = self.mix["ff_ticks"], self.mix["play_ticks"]
        fast = self.cfg["trick"]["speed"] * self.per
        return (fast * min(ticks, ff) + self.per * min(max(ticks - ff, 0), pl)
                - fast * min(max(ticks - ff - pl, 0), ff)
                + self.per * min(max(ticks - 2 * ff - pl, 0), pl))

    def keys_due(self, c: int) -> dict:
        """The keys the schedule sends before chunk `c`, {lane: key} in
        lane order, given the lanes' streams now.  Before the first chunk
        a trick lane whose phase falls inside its fast-forward or rewind
        stretch starts it, so the lanes join their cycles mid-way."""
        t = self.t
        ff, pl = self.ff, self.pl
        seg = (c + t.trick_phase) % (2 * (ff + pl))
        sp = self.speed[t.trick]
        first = c == 0
        due = {}
        for at, end, now, key in ((0, ff, 0, RT.KEY_RIGHT),
                                  (ff, ff, 1, RT.KEY_PLAY),
                                  (ff + pl, 2 * ff + pl, 0, RT.KEY_LEFT),
                                  (2 * ff + pl, 2 * ff + pl, -1,
                                   RT.KEY_PLAY)):
            go = (seg == at) | (first & (seg > at) & (seg < end))
            for lane in t.trick[go & (sp == now)]:
                due[int(lane)] = key
        n = c + t.skip_phase
        for j in np.flatnonzero((n % self.skip_every == 0)
                                & (self.speed[t.skip] == 0)):
            up = t.skip_up[j, n[j] // self.skip_every % t.skip_up.shape[1]]
            due[int(t.skip[j])] = RT.KEY_UP if up else RT.KEY_DOWN
        return dict(sorted(due.items()))

    def _renavigate(self):
        """Between chunks: ended lanes move on, then the keys."""
        super()._renavigate()
        keys = self.keys_due(self.chunk_no)
        self.fleet.apply_keys(keys)
        if keys:
            self.keys[self.chunk_no] = list(keys.items())
            for lane, key in keys.items():
                self.speed[lane] = KEY_SPEED[key]
        self.speeds.append(self.speed.copy())

    def _run(self):
        out = super()._run()
        # a chunk's "title" is the stream each lane plays: 3 x title +
        # speed + 1 (rewind, main, forward)
        title, pts, shown = self.chunks[-1]
        self.chunks[-1] = (3 * title + self.speeds[-1] + 1, pts, shown)
        return out

    def _pictures(self, control: bool = False) -> dict:
        """The reference's pictures of every stream of every title on the
        device, {p: uint8[3 x titles, period, H, W]}; a trick stream's
        shorter period repeats to the main stream's."""
        es = [e for m, (fw, rw) in zip(self.t.es, self.t.trick_es)
              for e in (rw, m, fw)]
        ref = media.decode_all(es, control=control)
        P = self.t.period
        return {p: torch.as_tensor(np.stack([np.stack([
            qs[j % len(qs)][n] for j in range(P)]) for qs, _st in ref]),
            device=self.device) for n, p in enumerate("yuv")}

    def check(self) -> dict:
        out = super().check()
        out.update({k: (v, 0) for k, v in self._replay.items()})
        return out

    def _check_pts(self) -> int:
        """Follow every lane's player (reference/trick.Lane) over the
        chunks: its starts (the plays the harness began), the keys sent
        and a tick at a time what the program presented.  Counts `pts`
        (returned), `landing`, `ends` and `keys` (kept in _replay)."""
        n, K = self.t.lanes, self.K
        lanes = [RT.Lane(self.per) for _ in range(n)]
        plays = [list(p) for p in self.plays]
        bad = landing = ends = bad_keys = 0
        for c, (_sid, pts, shown) in enumerate(self.chunks):
            for i, L in enumerate(lanes):
                started = False
                while plays[i] and plays[i][0][0] == c:
                    _c, title, pos = plays[i].pop(0)
                    if c and L.state != RT.DONE:
                        ends += 1
                    L.start(self.titles[title], pos)
                    started = True
                if L.state == RT.DONE and not started:
                    ends += 1
            for lane, key in self.keys.get(c, ()):
                if not lanes[lane].key(key):
                    bad_keys += 1
            for k in range(K):
                p, m = pts[k], shown[k]
                for i, L in enumerate(lanes):
                    if not m[i]:
                        L.idle_tick()
                        continue
                    if L.fresh:
                        landing += int(p[i] != L.next_pts)
                    else:
                        bad += int(p[i] != L.next_pts)
                    L.present()
        self._replay = dict(landing=landing, ends=ends, keys=bad_keys)
        return bad

    def _check_audio(self) -> dict:
        """The served entry's audio checks over the warm chunk and the
        window's last two chunks (tapped SBC frames in their title's order,
        PDM words, checksums and the carry), each chunk's SBC history from
        the last frame the lane popped before it; and over every chunk,
        the frames tapped lanes popped while fast-forwarding or
        rewinding (`trick_sbc`)."""
        t, K = self.t, self.K
        S_ = self.cfg["frames_per_tick"] * 128 * self.cfg["audio"][
            "channels"]
        last = [None] * len(self.tap)
        before = {}
        trick_sbc = 0
        for c, (sid, _pts, _shown) in enumerate(self.chunks):
            before[c] = list(last)
            for k in range(K):
                words, _act, nval, _st = self.audio_log[c * K + k]
                for j, lane in enumerate(self.tap):
                    nv = int(nval[lane])
                    if not nv:
                        continue
                    if sid[lane] % 3 != 1:
                        trick_sbc += nv
                    last[j] = S._frames_of(words[j], nv)[-1]
        order = sorted(self.audio_kept)
        bad_frames = 0
        rows = []
        for c in order:
            rec, title = self.audio_kept[c], self.chunks[c][0] // 3
            for j, lane in enumerate(self.tap):
                period = t.audio[int(title[lane])]
                got = [S._frames_of(w, int(nv)) for w, nv in
                       zip(rec["words"][:, j], rec["nval"][:, lane])]
                flat = [f for tick in got for f in tick]
                index = {f: i for i, f in enumerate(period)}
                start = index.get(flat[0]) if flat else None
                if flat and (start is None or flat != [
                        period[(start + i) % len(period)]
                        for i in range(len(flat))]):
                    bad_frames += len(flat)
                    continue
                prev = before[c][j]
                dec = None if prev is None else RA.decode_frames([prev])[1]
                rows.append((c, j, got, dec))
        out = dict(audio_frames=bad_frames, trick_sbc=trick_sbc)
        if not rows:
            return dict(out, pdm=0, pdm_sum=0, pdm_carry=0)
        tap_rows = np.array([j for _c, j, _g, _d in rows], np.int64)
        lanes = np.array(self.tap, np.int64)[tap_rows]
        recs = [self.audio_kept[c] for c, *_r in rows]
        state = np.stack([np.zeros(3, np.int32) if c == 0 else
                          self.audio_kept[c]["pdm_in"][j]
                          for c, j, _g, _d in rows]).reshape(-1, 3)
        decs = [d for *_r, d in rows]
        bad_pdm = bad_sum = 0
        for k in range(K):
            pcm = np.zeros((len(rows), S_), np.int16)
            for r, (_c, _j, got, _d) in enumerate(rows):
                if got[k]:
                    p, decs[r] = RA.decode_frames(got[k], decs[r])
                    pcm[r, :len(p)] = p
            pick = [np.array([rec[key][k][lane] for rec, lane in
                              zip(recs, lanes)], dtype) for key, dtype in
                    (("act", bool), ("starved", bool))]
            words, state = RA.audio_out(pcm, state,
                                        np.zeros(len(rows), np.int32), *pick)
            got_w = np.array([rec["tap_pdm"][k][j] for rec, j in
                              zip(recs, tap_rows)]).reshape(words.shape)
            bad_pdm += int((words != got_w).sum())
            sums = (words.astype(np.int64).sum(axis=1) + (1 << 31)) \
                % (1 << 32) - (1 << 31)
            bad_sum += int((sums != np.array(
                [rec["pdm_sum"][k][lane] for rec, lane in zip(recs, lanes)],
                np.int64)).sum())
        last_c = order[-1]
        end = {j: state[r] for r, (c, j, _g, _d) in enumerate(rows)
               if c == last_c - 1}
        carry = sum(int((end[j] != self.audio_kept[last_c]["pdm_in"][j])
                        .sum())
                    for c, j, _g, _d in rows if c == last_c and j in end)
        return dict(out, pdm=bad_pdm, pdm_sum=bad_sum, pdm_carry=carry)
