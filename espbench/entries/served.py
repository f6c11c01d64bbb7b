"""Entry `served`: the host path from sessions to results.

Set-up writes the mix's service (titles with SBC audio) into a
directory of the run's TMPDIR, attaches one `PlayerSession` over
`file://` to every lane of a `Fleet(output=True, parser="pallas")`,
starts each on its seeded title and GOP, and runs warm chunks.  The
window calls `Fleet.run_chunk_full` in chunks of `ticks_per_chunk`
ticks, closed loop.  Titles outlast the window at today's speed; a lane
whose title ends all the same moves to its next seeded title from the
start between chunks (the Fleet applies control at chunk boundaries).
The fleet's timers are replaced by a subclass that also keeps each span, so a tick's latency runs from the start of its
gather to the return of its chunk, and the traced run labels the
device's idle gaps by the fleet's span open at the time.

Checked after the window, against what the reference works out from
the service and the lanes' plays:

- every presented picture of the window: its pts is the next picture of
  the lane's play (a play starts at its seeded GOP's first picture);
- the warm chunk and the last chunk: every presented lane's planes and
  field checksum, the checked lanes' whole fields;
- the warm chunk and the last two chunks: the checked lanes' SBC frames
  are their titles' frames in order, and their PDM words and checksums,
  the warm chunk's from the initial state, the others' from the
  program's modulator state at their start; and the state the reference
  reaches at the end of the second-to-last chunk against the program's
  at the start of the last.  How many frames a tick pops is the ring's
  fill, which the reference follows from the program;
- every lane-tick's error flags over the window.
"""

from __future__ import annotations

import shutil
import tempfile
import time
from contextlib import contextmanager

import numpy as np
import torch

from espflix_tpu_torch.runtime.events import Timers
from espflix_tpu_torch.runtime.player import PlayerSession, State
from espflix_tpu_torch.runtime.scheduler import Fleet

from espbench import stats, workload
from espbench.reference import audio as RA
from espbench.reference import composite as RC
from espbench.reference import media
from espbench.trace import Profile

PTS_HZ = 90000


class SpanTimers(Timers):
    """The fleet's timers, each span also kept as (name, start, end) on
    the host clock and opened as a profiler range `fleet.<name>`."""

    def __init__(self):
        super().__init__()
        self.spans = []

    @contextmanager
    def measure(self, name: str):
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(f"fleet.{name}"), \
                    super().measure(name):
                yield
        finally:
            self.spans.append((name, t0, time.perf_counter()))


class Cell:
    """One run of a served cell: set-up in the constructor, then
    `window`, `release` and `check`."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device,
                 trace: bool):
        self.cfg, self.mix, self.device = cfg, mix, device
        self.pal = cfg["standard"] == "pal"
        self.K = mix["ticks_per_chunk"]
        self.per = PTS_HZ // cfg["tick_hz"]
        self.gop = cfg["video"]["gop"]
        self.root = tempfile.mkdtemp(prefix="espbench-service-")
        self.t = t = workload.sessions(seed, cfg, mix, self.root)
        self.tap = [int(i) for i in t.checked]
        self.fleet = f = Fleet(t.lanes, words_per_lane=mix["words_per_lane"],
                               tick_rate=cfg["tick_hz"], parser="pallas",
                               output=True, pal=self.pal, device=device)
        f.timers = SpanTimers()
        self.audio_log = []
        gather = f._gather_audio_arrays

        def gather_audio(F):
            out = gather(F)
            words, act, nval, starved, _ch = out
            self.audio_log.append((words[self.tap].copy(), act.copy(),
                                   nval.copy(), starved.copy()))
            return out
        f._gather_audio_arrays = gather_audio
        # the harness's record of each lane's plays: [(chunk, title, gop)]
        self.plays = [[] for _ in range(t.lanes)]
        self.hops = np.zeros(t.lanes, np.int64)
        self.chunk_no = 0
        url = "file://" + self.root
        for i in range(t.lanes):
            s = PlayerSession(url, pal=self.pal)
            if not s.init_service():
                raise RuntimeError("the service did not load")
            self._start(i, s, int(t.first_title[i]), int(t.first_gop[i]))
            f.attach(i, s)
        self.chunks = []        # per chunk: (title[lanes], pts, presented)
        self.flagged = 0        # lane-ticks with an error flag, every chunk
        # per chunk, (audio records, PDM state at its start, tapped PDM
        # and PDM checksums): the warm chunk's and the last two chunks'
        self.audio_recs = {}
        self.warm = self._run()[0]
        for _ in range(mix["warm_chunks"] - 1):
            self._run()

    def _start(self, i: int, s: PlayerSession, title: int, gop: int):
        s.nav(title)
        s.info[title].pos = gop * self.gop * self.per
        s.play_pause()
        self.plays[i].append((self.chunk_no, title, gop))

    def _renavigate(self):
        t = self.t
        for i, s in enumerate(self.fleet.sessions):
            if s.state == State.DONE:
                s.menu()
                title = int(t.next_titles[i, self.hops[i] % t.next_titles
                                          .shape[1]])
                self.hops[i] += 1
                self._start(i, s, title, 0)

    def _run(self):
        """One chunk: (results, tick start times, end time)."""
        self._renavigate()
        f = self.fleet
        n0, a0 = len(f.timers.spans), len(self.audio_log)
        pdm_in = f.output.pdm_state
        title = np.array([p[-1][1] for p in self.plays])
        rs = f.run_chunk_full(self.K, tap_lanes=self.tap)
        end = time.perf_counter()
        starts = [s for name, s, _e in f.timers.spans[n0:]
                  if name == "gather_packed"]
        self.chunks.append((title, np.stack([r.pts for r in rs]),
                            np.stack([r.video_lanes for r in rs])))
        self.flagged += int(sum((r.errors | r.audio_errors).sum()
                                for r in rs))
        audio = self.audio_log[a0:]
        self.audio_recs[self.chunk_no] = (audio, pdm_in, [
            (r.tap_pdm, r.pdm_sum) for r in rs])
        if self.chunk_no > 2:
            self.audio_recs.pop(self.chunk_no - 2)
        self.chunk_no += 1
        return rs, starts, end

    def window(self, seconds: float, profile: Profile | None = None):
        lanes = self.t.lanes
        ticks_ms, presented, failed, chunks = [], 0, 0, 0
        self.first_chunk = len(self.chunks)
        t0 = time.perf_counter()
        while True:
            if profile is not None and chunks == 1:
                profile.start()
                n_spans = len(self.fleet.timers.spans)
            rs, starts, end = self._run()
            chunks += 1
            ticks_ms += [(end - s) * 1e3 for s in starts]
            presented += int(sum(r.video_lanes.sum() for r in rs))
            failed += int(sum((r.errors | r.audio_errors).sum() for r in rs))
            if profile is not None and chunks == 1 + self.mix["trace_chunks"]:
                profile.stop()
                profile.ticks = self.mix["trace_chunks"] * self.K
                spans = self.fleet.timers.spans[n_spans:]
            if time.perf_counter() - t0 >= seconds and \
                    (profile is None or profile.done):
                break
        window_s = time.perf_counter() - t0
        self.last = rs
        res = dict(attempted=chunks * self.K * lanes, failed=failed,
                   window_s=window_s, e2e={
                       "served_streams": stats.streams(
                           presented, window_s, self.cfg["tick_hz"]),
                       "served_tick_ms_p95": stats.percentile(ticks_ms, 95)})
        if profile is not None:
            res["timers_s"] = {}
            for name, s, e in spans:
                res["timers_s"][name] = res["timers_s"].get(name, 0.0) \
                    + (e - s)
        return res

    def release(self):
        """Keep the warm and last chunks' outputs and the audio records
        the check reads; drop the fleet and the service."""
        self.kept = [_keep(rs) for rs in (self.warm, self.last)]
        self.kept_chunks = [0, len(self.chunks) - 1]
        self.audio_kept = {c: _keep_audio(*rec, self.tap)
                           for c, rec in self.audio_recs.items()}
        del self.fleet, self.warm, self.last, self.audio_recs
        shutil.rmtree(self.root, ignore_errors=True)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def substitute_control(self):
        """Put the control in the program's place: the kept chunks'
        planes, field checksums and tapped fields are what the reference
        presents for the same pictures with its IDCT in float32
        (reference/refdec.idct_float32)."""
        low = self._pictures(control=True)
        for kept, c in zip(self.kept, self.kept_chunks):
            title, pts, shown = self.chunks[c]
            for k in range(self.K):
                lanes = np.flatnonzero(shown[k])
                if not len(lanes):
                    continue
                planes = self._presented(low, title, pts[k], lanes)
                for p, plane in zip("yuv", planes):
                    kept["planes"][p][k][torch.as_tensor(
                        lanes, device=self.device)] = plane
                ff, fs = self._fields(planes)
                kept["field_sum"][k][lanes] = fs.cpu().numpy()
                for j, lane in enumerate(self.tap):
                    if shown[k, lane]:
                        m = int(np.flatnonzero(lanes == lane)[0])
                        kept["tap_fields"][k][j] = ff[m].cpu().numpy()

    def _pictures(self, control: bool = False) -> dict:
        """The reference's pictures of every title's period on the
        device: {p: uint8[titles, period, H, W]}."""
        ref = media.decode_all(self.t.es, control=control)
        return {p: torch.as_tensor(np.stack([np.stack([q[n] for q in qs])
                                             for qs, _st in ref]),
                                   device=self.device)
                for n, p in enumerate("yuv")}

    def _presented(self, pics: dict, title, pts, lanes) -> list:
        """The planes of the pictures at `pts` of `title` for `lanes`."""
        dev = self.device
        ti = torch.as_tensor(title[lanes], device=dev)
        pj = torch.as_tensor(pts[lanes] // self.per % self.t.period,
                             device=dev)
        return [pics[p][ti, pj] for p in "yuv"]

    def _fields(self, planes):
        """The reference's field pair and checksum of presented planes
        (the served lanes' output state: no OSD, blend, progress or odd
        parity)."""
        n = planes[0].shape[0]
        zeros = torch.zeros(n, dtype=torch.int32, device=self.device)
        osd = torch.zeros((n, 16, 80), dtype=torch.uint8, device=self.device)
        return RC.field_pair(*planes, zeros, osd, zeros, zeros,
                             pal=self.pal)

    def check(self) -> dict:
        dev = self.device
        pics = self._pictures()
        out = dict(pts=self._check_pts(), planes=0, field_sum=0, fields=0,
                   flags=self.flagged)
        for kept, c in zip(self.kept, self.kept_chunks):
            title, pts, shown = self.chunks[c]
            for k in range(self.K):
                lanes = np.flatnonzero(shown[k])
                if not len(lanes):
                    continue
                want = self._presented(pics, title, pts[k], lanes)
                li = torch.as_tensor(lanes, device=dev)
                got = [kept["planes"][p][k][li] for p in "yuv"]
                out["planes"] += int(sum((a != b).sum()
                                         for a, b in zip(got, want)))
                ff, fs = self._fields(want)
                out["field_sum"] += int((fs.cpu().numpy()
                                         != kept["field_sum"][k][lanes]).sum())
                for j, lane in enumerate(self.tap):
                    if shown[k, lane]:
                        m = int(np.flatnonzero(lanes == lane)[0])
                        out["fields"] += int((ff[m].cpu().numpy()
                                              != kept["tap_fields"][k][j])
                                             .sum())
        out.update(self._check_audio())
        return {name: (v, 0) for name, v in out.items()}

    def _check_pts(self) -> int:
        """Presented lane-ticks of the window whose pts is not the next
        picture of the lane's play."""
        bad = 0
        plays = [list(p) for p in self.plays]
        expect = np.full(self.t.lanes, -1, np.int64)
        for c, (title, pts, shown) in enumerate(self.chunks):
            for i in range(self.t.lanes):
                while plays[i] and plays[i][0][0] == c:
                    _c, _title, gop = plays[i].pop(0)
                    expect[i] = gop * self.gop * self.per
            if c < self.first_chunk:
                # before the window: follow the plays without judging
                for k in range(self.K):
                    expect[shown[k]] = pts[k, shown[k]] + self.per
                continue
            for k in range(self.K):
                m = shown[k]
                bad += int((pts[k, m] != expect[m]).sum())
                expect[m] = pts[k, m] + self.per
        return bad

    def _check_audio(self) -> dict:
        """Over the warm chunk and the window's last two chunks, the
        checked lanes': SBC frames that are not their title's frames in
        order (a title repeats its period of frames); PDM words and
        checksums that differ; and the modulator state the reference
        reaches at the end of the second-to-last chunk that differs from
        the program's at the start of the last.  The warm chunk starts
        from the initial state (no SBC history, the modulator at zero), a
        later one from the frame before in the lane's title and the
        program's modulator state, as one batch of rows; a lane that
        began a play in a later chunk (its history in another title) is
        left out of that chunk's PDM."""
        t = self.t
        order = sorted(self.audio_kept)
        S = self.cfg["frames_per_tick"] * 128 * self.cfg["audio"][
            "channels"]
        bad_frames = 0
        rows = []           # (chunk, tap row, frames per tick, decoder)
        for c in order:
            rec, title = self.audio_kept[c], self.chunks[c][0]
            for j, lane in enumerate(self.tap):
                period = t.audio[int(title[lane])]
                got = [_frames_of(w, int(nv)) for w, nv in
                       zip(rec["words"][:, j], rec["nval"][:, lane])]
                flat = [f for tick in got for f in tick]
                index = {f: k for k, f in enumerate(period)}
                start = index.get(flat[0]) if flat else None
                if flat and (start is None or flat != [
                        period[(start + i) % len(period)]
                        for i in range(len(flat))]):
                    bad_frames += len(flat)
                    continue
                if c and any(pc == c for pc, _t, _g in self.plays[lane]):
                    continue
                dec = None if c == 0 or not flat else RA.decode_frames(
                    [period[(start - 1) % len(period)]])[1]
                rows.append((c, j, got, dec))
        if not rows:
            return dict(audio_frames=bad_frames, pdm=0, pdm_sum=0,
                        pdm_carry=0)
        tap_rows = np.array([j for _c, j, _g, _d in rows], np.int64)
        lanes = np.array(self.tap, np.int64)[tap_rows]
        recs = [self.audio_kept[c] for c, *_r in rows]
        state = np.stack([np.zeros(3, np.int32) if c == 0 else
                          self.audio_kept[c]["pdm_in"][j]
                          for c, j, _g, _d in rows]).reshape(-1, 3)
        decs = [d for *_r, d in rows]
        bad_pdm = bad_sum = 0
        for k in range(self.K):
            pcm = np.zeros((len(rows), S), np.int16)
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
        last = order[-1]
        end = {j: state[r] for r, (c, j, _g, _d) in enumerate(rows)
               if c == last - 1}
        carry = sum(int((end[j] != self.audio_kept[last]["pdm_in"][j]).sum())
                    for c, j, _g, _d in rows if c == last and j in end)
        return dict(audio_frames=bad_frames, pdm=bad_pdm, pdm_sum=bad_sum,
                    pdm_carry=carry)


def _keep(rs) -> dict:
    return dict(
        planes={p: torch.stack([getattr(r, p) for r in rs]) for p in "yuv"},
        field_sum=np.stack([r.field_sum for r in rs]),
        tap_fields=np.stack([r.tap_fields for r in rs]))


def _keep_audio(audio, pdm_in, taps, tap) -> dict:
    return dict(
        words=np.stack([a[0] for a in audio]),
        act=np.stack([a[1] for a in audio]),
        nval=np.stack([a[2] for a in audio]),
        starved=np.stack([a[3] for a in audio]),
        tap_pdm=np.stack([p for p, _s in taps]),
        pdm_sum=np.stack([s for _p, s in taps]),
        pdm_in=pdm_in[torch.as_tensor(tap)].cpu().numpy())


def _frames_of(words: np.ndarray, n: int) -> list:
    """The first n SBC frames of a lane's tick, from the big-endian
    words the gather made, each cut to its own length."""
    out = []
    for f in range(n):
        b = words[f].astype(">u4").tobytes()
        out.append(b[:_frame_len(b)])
    return out


def _frame_len(b: bytes) -> int:
    """An SBC frame's length from its header (mono/dual/stereo/joint,
    8 subbands)."""
    blocks = (4, 8, 12, 16)[(b[1] >> 4) & 3]
    mode = (b[1] >> 2) & 3
    ch = 1 if mode == 0 else 2
    sb = 8 if b[1] & 1 else 4
    bitpool = b[2]
    n = 4 + (4 * sb * ch) // 8
    if mode in (0, 1):
        return n + -(-(blocks * ch * bitpool) // 8)
    join = sb if mode == 3 else 0
    return n + -(-(join + blocks * bitpool) // 8)
