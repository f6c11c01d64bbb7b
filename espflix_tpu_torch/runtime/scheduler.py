"""Fleet scheduler: N playback sessions through the full device chain.

The port of espflix_tpu.runtime.scheduler's serving path on one device
(scheduler.py:50-98, 101-384, 1060-1379): each lane is one
PlayerSession (control plane + bounded network pump); every tick the
fleet gathers at most one complete picture and one tick of SBC frames
per lane, snapshots the per-lane OSD/animation/beep state, and
``run_chunk_full`` runs K ticks of the complete loop -- decode, both
composite fields, SBC and PDM (runtime/chain.FullChain, kernels K1-K5
on a CUDA device) -- in one call.  Frames, SBC history and modulator
state stay on the fleet's device across chunks; presented planes stay
there too (TickResult y/u/v are device tensors), and only checksums,
error flags and the tapped lanes' signal reach the host.  Starved or
idle lanes are masked; a corrupt stream only parks its own lane.

Not ported yet (each raises NotImplementedError; ROADMAP.md): a parser
other than "pallas" (the slice scan K1 is the port's only parser), a
mesh, output=False and the decode-only ticks (tick_submit /
tick_collect / run_chunk / run_pipelined), run_chunk_full_pooled with a
HostPool, and the native session feed with its batched and packed pops.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from espflix_tpu.audio.sbc import SbcDecoder
from espflix_tpu.runtime.events import Ev, EventLog, Timers
from espflix_tpu_torch.models import mpeg1 as M
from espflix_tpu_torch.models import sbc as dsbc
from espflix_tpu_torch.ops import scan_dense as SD
from espflix_tpu_torch.ops import vlc_scan as VS
from espflix_tpu_torch.runtime import chain as CH
from espflix_tpu_torch.runtime.output import OutputStage
from espflix_tpu_torch.runtime.player import PlayerSession, State


@dataclass
class TickResult:
    video_lanes: np.ndarray          # bool[N] lanes with a new frame
    y: object                        # presented planes (device tensors)
    u: object
    v: object
    pts: np.ndarray                  # int64[N] (-1 if none)
    errors: np.ndarray               # bool[N]
    audio_lanes: np.ndarray          # bool[N] lanes with new PCM
    pcm: np.ndarray | None           # int16[N, <=F*2*128] (see pcm_samples)
    pcm_samples: np.ndarray | None = None  # int32[N] valid samples per lane
    audio_starved: np.ndarray | None = None  # bool[N] playing lanes that
    # underran their SBC ring this tick; the output stage substitutes
    # PDM silence for them (video.cpp:997-1001)
    audio_errors: np.ndarray | None = None  # bool[N] lanes whose SBC
    # decode flagged an anomaly this tick (video.cpp:1013-1014)
    field_sum: np.ndarray | None = None   # int32[N] checksum of both
    # composite fields (full-chain ticks only, runtime/chain.py)
    pdm_sum: np.ndarray | None = None     # int32[N] checksum of the
    # tick's PDM words (full-chain ticks only)
    tap_fields: np.ndarray | None = None  # uint8[tap, 2, L, W] full
    # DAC fields for the tapped lanes
    tap_pdm: np.ndarray | None = None     # int32[tap, S] PDM words


def _quantize_pow2(x: int, lo: int, hi: int) -> int:
    """Round x up to a power of two, clamped to [lo, hi] (copied from
    espflix_tpu.models.mpeg1._quantize_pow2, mpeg1.py:705)."""
    p = lo
    while p < x and p < hi:
        p *= 2
    return min(max(p, lo), hi)


def bucket_policy(need: int, ns_rows: int, *, steps_long: int,
                  steps_short: int, floor: int = 8):
    """Sizing of the two-bucket slice scan (scheduler.py:76-98).

    The slice rows are span-sorted, so the long bucket must absorb
    `need` rows (every I picture's rows).  long_rows = need rounded up
    to a power of two, clamped to [floor, ns_rows - floor] and at most
    half the rows; a tick whose long rows exceed half the batch
    escalates the SHORT bucket's budget to the long one.

    Returns (long_rows, steps_long, steps_short).
    """
    if need > ns_rows // 2:
        steps_short = steps_long
    long_rows = _quantize_pow2(min(need, max(ns_rows // 2, floor)),
                               floor, max(ns_rows - floor, floor))
    return long_rows, steps_long, steps_short


_PUMP_STATES = (State.PLAYING, State.FAST_FORWARD, State.REWIND)


class Fleet:
    def __init__(self, n_lanes: int, width: int = 352, height: int = 192,
                 words_per_lane: int = 16384, mesh=None,
                 audio_frames_per_tick: int | None = None,
                 tick_rate: float = 30.0,
                 parser: str = "pallas", output: bool = True,
                 pal: bool = False, device="cpu"):
        """The serving fleet on one `device` (the JAX Fleet with
        parser='pallas', output=True and no mesh; see the module
        docstring for what is not ported)."""
        if parser != "pallas":
            raise NotImplementedError(
                f"parser {parser!r}: the port runs the slice scan (K1) "
                "only")
        if mesh is not None:
            raise NotImplementedError("the sharded fleet is not ported")
        if not output:
            raise NotImplementedError(
                "the decode-only fleet (output=False) is not ported")
        self.n = n_lanes
        self.width, self.height = width, height
        self.mb_w, self.mb_h = (width + 15) >> 4, (height + 15) >> 4
        self.words_per_lane = words_per_lane
        self.device = torch.device(device)
        # real-time audio provisioning: at tick_rate display ticks/s
        # each lane drains 48000 / 128 / tick_rate SBC frames per tick
        # (13 at 30 fps) or its ring backs up (video.cpp:990-1004)
        if audio_frames_per_tick is None:
            audio_frames_per_tick = -(-48000 // (128 * int(tick_rate)))
        self.audio_F = audio_frames_per_tick
        self.sessions: list[PlayerSession | None] = [None] * n_lanes
        self.events = EventLog()
        self.timers = Timers()
        self.pal = pal
        self._aud_op = None       # discovered channel-count group
        self.output = OutputStage(n_lanes, pal=pal, device=self.device)
        self.frames = M.init_frame_state(n_lanes, self.mb_w * 16,
                                         self.mb_h * 16, self.device)
        self.sbc_state = dsbc.init_state(n_lanes, self.device)
        # one chain module (constant tables on the device) for the
        # fleet's lifetime
        self.chain = CH.FullChain(pal=pal, n_aud_frames=self.audio_F,
                                  device=self.device)
        # device-side scan-row windowing: ship [N, Wm] per-lane words
        # and gather the [NS, win] row windows on the device;
        # ESPFLIX_DEVICE_WINDOWS=0 restores host-built windows
        self._dev_win = os.environ.get(
            "ESPFLIX_DEVICE_WINDOWS", "1") != "0"

    @staticmethod
    def _sbc_probe(data: bytes):
        d = SbcDecoder()
        r = d.parse_frame(data)
        if not r:
            return 0
        return r[1], d.channels, d.blocks

    def attach(self, lane: int, session: PlayerSession):
        self.sessions[lane] = session

    # -- fleet checkpoint/restore (SURVEY.md 5.4) -----------------------
    def snapshot(self) -> list:
        return [s.snapshot() if s is not None else None
                for s in self.sessions]

    def restore(self, snaps: list) -> int:
        ok = 0
        for i, snap in enumerate(snaps):
            if snap is not None and self.sessions[i] is not None:
                ok += bool(self.sessions[i].restore(snap))
        return ok

    def _not_ported(self, *_a, **_k):
        raise NotImplementedError(
            "the decode-only ticks (tick_submit / tick_collect / "
            "run_chunk / run_pipelined) and run_chunk_full_pooled are not "
            "ported; run_chunk_full is the port's serving path")

    tick = tick_submit = tick_collect = run_chunk = run_pipelined = \
        run_chunk_full_pooled = _not_ported

    # -- host gather ----------------------------------------------------
    def _gather_pictures(self):
        """One display-tick of host work: advance every session's
        presentation clock, pull at most one complete picture per lane,
        and apply the geometry/oversize containment policies."""
        n = self.n
        pics = [None] * n
        pts = np.full(n, -1, np.int64)
        # one tick = one display frame interval (video.cpp:1165)
        for s in self.sessions:
            if s is not None:
                s.clock.tick()
        pre_errors = np.zeros(n, bool)
        for i, s in enumerate(self.sessions):
            if s is None:
                continue
            p = s.next_picture()
            if p is None:
                continue
            if p.seq.width != self.width or p.seq.height != self.height:
                # a stream of the wrong geometry can never decode into
                # this fleet's frame planes: flag and park the lane
                self.events.log(Ev.LANE_GEOMETRY, i,
                                value=(p.seq.width << 16) | p.seq.height)
                pre_errors[i] = True
                s.park(f"geometry {p.seq.width}x{p.seq.height} != "
                       f"fleet {self.width}x{self.height}")
                s.park_geometry = (p.seq.width, p.seq.height)
                continue
            if (len(p.payload) + 3) // 4 + 4 > self.words_per_lane:
                # transient oversize picture: drop it, flag the lane and
                # re-seek to the next random-access point (SURVEY.md 5.3)
                self.events.log(Ev.LANE_OVERSIZE, i,
                                value=len(p.payload))
                pre_errors[i] = True
                if s.resync():
                    self.events.log(Ev.LANE_RESYNC, i)
                continue
            pics[i] = p
            pts[i] = p.pts
        return pics, pts, pre_errors

    def _update_osd(self):
        """Per-tick OSD glue (espflix.cpp:862-884): refresh the time
        readout + progress bar for lanes showing the overlay."""
        out = self.output
        for i, s in enumerate(self.sessions):
            if s is None or out.blend[i] == 0:
                continue
            if s.state not in (State.PLAYING, State.PAUSED,
                               State.FAST_FORWARD, State.REWIND):
                continue
            ti = s.info.get(s.nav_index)
            if not ti or not ti.idx_hdr:
                continue
            icon = out.icon_for(s.speed, s.state == State.PAUSED)
            out.update_progress(i, ti.pos, ti.idx_hdr.video.last_pts,
                                icon)

    def _gather_audio_arrays(self, F: int):
        """One tick of SBC frames as fixed-shape chain inputs
        (scheduler.py:1078-1165, SbcRing lanes).  Lanes group by
        channel count (the first discovered 16-block lane sets it);
        frame sizes vary freely per lane and pad to the tick's largest,
        quantized to 32 bytes.  A lane outside the group is silent in
        the chain and logs Ev.AUDIO_OP_POINT."""
        n = self.n
        starved = np.zeros(n, bool)
        act = np.zeros(n, bool)
        nval = np.zeros(n, np.int32)
        frames_list: list[tuple[int, np.ndarray]] = []
        fs_max = 16
        for i, s in enumerate(self.sessions):
            if s is None:
                continue
            ring = s.feed.audio
            if not (ring.discover(self._sbc_probe) and ring.frame_size):
                continue
            if self._aud_op is None and ring.blocks == 16:
                self._aud_op = ring.channels
            if self._aud_op is None or ring.blocks != 16 \
                    or ring.channels != self._aud_op:
                self.events.log(Ev.AUDIO_OP_POINT, i,
                                value=(ring.channels << 8) | ring.blocks)
                continue
            fa = ring.pop_frames_array(F)
            if fa is None:
                if s.state in _PUMP_STATES and not s.eos:
                    starved[i] = True
                    self.events.log(Ev.AUDIO_STARVED, i)
                continue
            act[i] = True
            nval[i] = len(fa)
            fs_max = max(fs_max, fa.shape[1])
            frames_list.append((i, fa))
        ch = self._aud_op if self._aud_op else 1
        fs_q = -(-fs_max // 32) * 32
        # word-padded rows (+4 trailing zero bytes) so the words are a
        # dtype view + in-place byteswap
        arr = np.zeros((n, F, fs_q + 4), np.uint8)
        for i, fa in frames_list:
            arr[i, :len(fa), :fa.shape[1]] = fa
        words = arr.view(np.uint32)
        words.byteswap(inplace=True)
        return words, act, nval, starved, ch

    # -- full-path chunk: decode + composite + SBC + PDM on device -------
    def run_chunk_full(self, n_ticks: int, tap_lanes=(),
                       steps_long: int = 1024, steps_short: int = 384,
                       chunk: int = 128) -> list[TickResult]:
        """K ticks of the complete reference loop in one chain call:
        decode + both composite fields (real per-lane OSD/progress/
        slide/beep/starved state) + SBC + delta-sigma PDM.  Presented
        planes, fields and PDM stay on the device (checksums in the
        TickResult; tap_lanes get their full DAC fields and PDM words
        back).  Control-plane effects apply at chunk boundaries."""
        F = self.audio_F
        gathered = []
        xs_t = []
        dup_any = np.zeros(self.n, bool)
        need_long = 8
        ch = 1
        for _ in range(n_ticks):
            with self.timers.measure("gather"):
                pics, pts, pre_errors = self._gather_pictures()
            with self.timers.measure("batch_assemble"):
                b = M.make_picture_batch(
                    pics, words_per_lane=self.words_per_lane,
                    max_slices=self.mb_h,
                    geometry=(self.mb_w, self.mb_h))
                # the long symbol bucket absorbs every I picture's rows
                is_i = (b["pic_type"] == 1) & b["active"]
                need_long = max(need_long, int(is_i.sum()) * self.mb_h)
                sl = VS.pack_slice_rows(b, sort_rows=True,
                                        device_windows=self._dev_win)
                perm, dup = SD.row_perm(sl["lane_of_row"], sl["rows"],
                                        sl["alive"], self.n, self.mb_h)
            dup_any |= dup
            with self.timers.measure("gather"):
                aud_words, aact, anval, starved, ch = \
                    self._gather_audio_arrays(F)
                self._update_osd()
                snap = self.output.tick_state(F)
            dkeys = CH.DECODE_KEYS_DW[:9] if self._dev_win \
                else CH.DECODE_KEYS[:8]
            x = {k: sl[k] for k in dkeys}
            if self._dev_win:
                x["win"] = sl["win"]
            x["perm"] = perm
            for k in ("intra_q", "non_intra_q", "active"):
                x[k] = b[k]
            for k in ("osd", "blend", "progress", "parity", "hscroll",
                      "beep_left"):
                x[k] = snap[k]
            x["aud_words"] = aud_words
            x["aud_act"] = aact
            x["aud_nval"] = anval
            x["starved"] = starved
            xs_t.append(x)
            gathered.append((b["active"].copy(), pts, pre_errors, starved))

        with self.timers.measure("batch_assemble"):
            # common word-window width across the chunk
            if self._dev_win:
                win = max(x.pop("win") for x in xs_t)
                wkey = "lane_words"
            else:
                win = 0
                wkey = "words"
            Wm = max(x[wkey].shape[1] for x in xs_t)
            for x in xs_t:
                x[wkey] = np.pad(x[wkey],
                                 ((0, 0), (0, Wm - x[wkey].shape[1])))
            # audio word width follows the tick's largest SBC frame
            Wa = max(x["aud_words"].shape[2] for x in xs_t)
            for x in xs_t:
                x["aud_words"] = np.pad(
                    x["aud_words"],
                    ((0, 0), (0, 0), (0, Wa - x["aud_words"].shape[2])))
            xs = CH.xs_to_torch({k: np.stack([x[k] for x in xs_t])
                                 for k in xs_t[0]}, self.device)
        self.events.log(Ev.DECODE_BATCH, value=sum(
            int(x["active"].sum()) for x in xs_t))

        scrolled = any((x["hscroll"] != 0).any() for x in xs_t)
        sld = self.output.slide_planes()
        slide = None
        if scrolled and sld is not None:
            slide = tuple(torch.from_numpy(s).to(self.device) for s in sld)
        else:
            scrolled = False
        tap = len(tap_lanes)
        tap_idx = torch.tensor(list(tap_lanes) or [0], dtype=torch.int32,
                               device=self.device)

        long_rows, steps_long, steps_short = bucket_policy(
            need_long, self.n * self.mb_h, steps_long=steps_long,
            steps_short=steps_short)
        with self.timers.measure("device_chain"):
            (self.frames, self.sbc_state, self.output.pdm_state,
             outs) = self.chain(
                xs, self.frames, self.sbc_state, self.output.pdm_state,
                tap_idx, mb_width=self.mb_w, mb_height=self.mb_h,
                n_lanes=self.n, long_rows=long_rows,
                steps_long=steps_long, steps_short=steps_short, tap=tap,
                channels=ch, return_planes=True, win=win,
                chunk=min(chunk, steps_short), scrolled=scrolled,
                slide=slide)

        with self.timers.measure("host_sync"):
            errs = outs["err"].cpu().numpy() | dup_any[None, :]
            fsum = outs["field_sum"].cpu().numpy()
            psum = outs["pdm_sum"].cpu().numpy()
            audio_errs = outs["audio_err"].cpu().numpy()
            tap_f = outs["tap_fields"].cpu().numpy() if tap else None
            tap_p = outs["tap_pdm"].cpu().numpy() if tap else None

        results = []
        for t, (video_lanes, pts, pre_errors, starved) in \
                enumerate(gathered):
            errors = errs[t].copy()
            for i in np.nonzero(video_lanes)[0]:
                if self.sessions[i] is not None:
                    self.sessions[i].on_presented(int(pts[i]))
                    if errors[i]:
                        self.events.log(Ev.LANE_ERROR, i)
                        if self.sessions[i].resync():
                            self.events.log(Ev.LANE_RESYNC, i)
            for i in np.nonzero(audio_errs[t])[0]:
                self.events.log(Ev.AUDIO_ERROR, int(i))
            results.append(TickResult(
                video_lanes, outs["y"][t], outs["u"][t], outs["v"][t],
                pts, errors | pre_errors,
                audio_lanes=xs_t[t]["aud_act"],
                pcm=None, pcm_samples=None, audio_starved=starved,
                audio_errors=audio_errs[t],
                field_sum=fsum[t], pdm_sum=psum[t],
                tap_fields=tap_f[t] if tap else None,
                tap_pdm=tap_p[t] if tap else None))
        return results
