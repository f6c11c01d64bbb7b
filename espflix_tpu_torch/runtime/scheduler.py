"""Fleet scheduler: N playback sessions through batched device decode.

The port of espflix_tpu.runtime.scheduler on one device, parser
"pallas" (the slice scan, the port's only parser): each lane is one
PlayerSession (control plane + bounded network pump); every tick the
fleet gathers at most one complete picture and one tick of SBC frames
per lane.  Starved or idle lanes are masked; a corrupt stream only
parks its own lane.  Two serving modes, as in the JAX package:

  * decode-only (output=False, the default; scheduler.py:270-958):
    ``tick_submit`` / ``tick_collect`` (``tick``, ``run_pipelined``)
    decode one tick through models/mpeg1.decode_picture_batch_sliced --
    K1 -> K2 -> K3, or K1F -> K2F -> K3F for small fleets -- and the
    SBC audio per (frame size, channels) group; ``run_chunk`` decodes K
    ticks through K1F -> K2F -> K3F with one host sync per chunk.
    TickResult planes are numpy (fetch_frames=True) or device tensors;
  * full path (output=True; scheduler.py:1060-1379): ``run_chunk_full``
    runs K ticks of decode, both composite fields, SBC and PDM
    (runtime/chain.FullChain, kernels K1-K5) in one call; presented
    planes stay on the device, only checksums, error flags and the
    tapped lanes' signal reach the host.

Frames and SBC history stay on the fleet's device (CUDA by default).
Not ported yet (each raises NotImplementedError; ROADMAP.md): the
"device" and "hybrid" parsers, a mesh, run_chunk_full_pooled with a
HostPool, and the native session feed with its batched and packed
pops.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from espflix_tpu_torch.audio.sbc import SbcDecoder
from espflix_tpu_torch.models import mpeg1 as M
from espflix_tpu_torch.models import sbc as dsbc
from espflix_tpu_torch.ops import scan_dense as SD
from espflix_tpu_torch.ops import vlc_scan as VS
from espflix_tpu_torch.runtime import chain as CH
from espflix_tpu_torch.runtime.events import Ev, EventLog, Timers
from espflix_tpu_torch.runtime.output import OutputStage
from espflix_tpu_torch.runtime.player import PlayerSession, State


@dataclass
class PendingTick:
    """In-flight tick: device work dispatched, host sync deferred
    (scheduler.py:28-47).  Produced by Fleet.tick_submit(), finished by
    Fleet.tick_collect(); in between the card decodes while the host
    pumps sessions for the next tick."""
    pics: list
    pts: np.ndarray
    pre_errors: np.ndarray
    presented: object | None         # device tensors (y/u/v) or None
    info: object | None              # device error flags
    audio_device: list               # [(members, pcm, err, channels)]
    host_pcm: dict
    audio_lanes: np.ndarray
    audio_starved: np.ndarray
    pcm_width: int


@dataclass
class TickResult:
    video_lanes: np.ndarray          # bool[N] lanes with a new frame
    y: object                        # presented planes: numpy, or device
    u: object                        # tensors (fetch_frames=False and
    v: object                        # run_chunk_full)
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
    long_rows = M._quantize_pow2(min(need, max(ns_rows // 2, floor)),
                                 floor, max(ns_rows - floor, floor))
    return long_rows, steps_long, steps_short


_PUMP_STATES = (State.PLAYING, State.FAST_FORWARD, State.REWIND)


class Fleet:
    def __init__(self, n_lanes: int, width: int = 352, height: int = 192,
                 words_per_lane: int = 16384, mesh=None,
                 audio_frames_per_tick: int | None = None,
                 tick_rate: float = 30.0,
                 parser: str = "pallas", output: bool = False,
                 pal: bool = False, device="cuda"):
        """The fleet on one `device` (the JAX Fleet with
        parser='pallas' and no mesh).  output=False is the decode-only
        fleet (tick, run_pipelined, run_chunk); output=True adds the
        OutputStage and the full chain (run_chunk_full).  Raises
        NotImplementedError for the 'device' and 'hybrid' parsers and
        for a mesh."""
        if parser != "pallas":
            raise NotImplementedError(
                f"parser {parser!r}: the port runs the slice scan (K1, "
                "K1F) only")
        if mesh is not None:
            raise NotImplementedError("the sharded fleet is not ported")
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
        self.parser = parser
        self._aud_op = None       # discovered channel-count group
        self.frames = M.init_frame_state(n_lanes, self.mb_w * 16,
                                         self.mb_h * 16, self.device)
        self.sbc_state = dsbc.init_state(n_lanes, self.device)
        self.tables = M.decode_tables(self.device)
        self.output = self.chain = None
        if output:
            self.output = OutputStage(n_lanes, pal=pal, device=self.device)
            # one chain module (constant tables on the device) for the
            # fleet's lifetime
            self.chain = CH.FullChain(pal=pal, n_aud_frames=self.audio_F,
                                      device=self.device)
        # device-side scan-row windowing in run_chunk_full: ship [N, Wm]
        # per-lane words and gather the [NS, win] row windows on the
        # device; ESPFLIX_DEVICE_WINDOWS=0 restores host-built windows
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

    def run_chunk_full_pooled(self, *_a, **_k):
        raise NotImplementedError(
            "run_chunk_full_pooled (HostPool) is not ported; "
            "run_chunk_full is the port's full serving path")

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

    # -- one decode tick (decode-only fleet) ------------------------------
    def tick(self, decode_audio: bool = True,
             fetch_frames: bool = True) -> TickResult:
        """Synchronous tick: submit + collect back-to-back."""
        return self.tick_collect(self.tick_submit(decode_audio),
                                 fetch_frames=fetch_frames)

    def run_pipelined(self, n_ticks: int, decode_audio: bool = True,
                      fetch_frames: bool = True) -> list[TickResult]:
        """n_ticks with host/device overlap: tick t+1's host work
        (session pump, batch assembly, launches) runs while the card
        still decodes tick t (scheduler.py:276-292)."""
        results = []
        pend = self.tick_submit(decode_audio)
        for _ in range(n_ticks - 1):
            nxt = self.tick_submit(decode_audio)
            results.append(self.tick_collect(pend,
                                             fetch_frames=fetch_frames))
            pend = nxt
        results.append(self.tick_collect(pend, fetch_frames=fetch_frames))
        return results

    def tick_submit(self, decode_audio: bool = True) -> PendingTick:
        """Gather one tick's pictures, launch its decode and its SBC
        decode; nothing waits for the card (scheduler.py:565-658)."""
        pics, pts, pre_errors = self._gather_pictures()
        presented = info = None
        if any(p is not None for p in pics):
            self.events.log(Ev.DECODE_BATCH,
                            value=int(sum(p is not None for p in pics)))
            with self.timers.measure("batch_assemble"):
                b = M.make_picture_batch(
                    pics, words_per_lane=self.words_per_lane,
                    max_slices=self.mb_h,
                    geometry=(self.mb_w, self.mb_h))
            with self.timers.measure("device_decode"):
                self.frames, presented, info = \
                    M.decode_picture_batch_sliced(
                        b, self.frames, mb_width=self.mb_w,
                        mb_height=self.mb_h, tables=self.tables)
        (audio_device, host_pcm, audio_lanes, audio_starved,
         pcm_width) = self._submit_audio(decode_audio)
        return PendingTick(pics, pts, pre_errors, presented, info,
                           audio_device, host_pcm, audio_lanes,
                           audio_starved, pcm_width)

    def _submit_audio(self, decode_audio: bool):
        """Gather one tick's SBC frames from every lane's ring and launch
        one batched decode per (frame size, channels) group; frames the
        batched model rejects (blocks != 16) decode on the host
        (scheduler.py:660-734)."""
        n = self.n
        audio_lanes = np.zeros(n, bool)
        audio_starved = np.zeros(n, bool)
        audio_device = []
        host_pcm: dict[int, np.ndarray] = {}
        pcm_width = 0
        if not decode_audio:
            return (audio_device, host_pcm, audio_lanes, audio_starved,
                    pcm_width)
        F = self.audio_F
        groups: dict[tuple[int, int], list[tuple[int, np.ndarray]]] = {}
        for i, s in enumerate(self.sessions):
            if s is None:
                continue
            ring = s.feed.audio
            if not (ring.discover(self._sbc_probe) and ring.frame_size):
                continue
            if ring.blocks == 16:
                fa = ring.pop_frames_array(F)
                if fa is None:
                    if s.state in _PUMP_STATES and not s.eos:
                        audio_starved[i] = True
                        self.events.log(Ev.AUDIO_STARVED, i)
                    continue
                groups.setdefault((ring.frame_size, ring.channels),
                                  []).append((i, fa))
            else:
                # nonstandard block count: host scalar decode
                fr = ring.pop_frames(F)
                if not fr:
                    if s.state in _PUMP_STATES and not s.eos:
                        audio_starved[i] = True
                        self.events.log(Ev.AUDIO_STARVED, i)
                    continue
                s._host_audio = getattr(s, "_host_audio", SbcDecoder())
                out = []
                for f in fr:
                    r = s._host_audio.decode_frame(f)
                    if r:
                        out.append(r[0])
                if out:
                    host_pcm[i] = np.concatenate(out)
        if groups or host_pcm:
            pcm_width = max([F * ch * 128 for (_, ch) in groups]
                            + [len(p) for p in host_pcm.values()])
        for (fs, ch), members in groups.items():
            arr = np.zeros((n, F, fs), np.uint8)
            nval = np.zeros(n, np.int32)
            act = np.zeros(n, bool)
            for i, fa in members:
                nval[i] = len(fa)
                act[i] = True
                arr[i, :len(fa)] = fa
            words = torch.from_numpy(
                dsbc.frames_to_words(arr).view(np.int32)).to(self.device)
            with self.timers.measure("audio_decode"):
                out, self.sbc_state, err, _ = dsbc.decode_frames_batched(
                    words, self.sbc_state,
                    active=torch.from_numpy(act).to(self.device),
                    n_valid=torch.from_numpy(nval).to(self.device),
                    n_frames=F, channels=ch)
            audio_device.append((members, out, err, ch))
        return (audio_device, host_pcm, audio_lanes, audio_starved,
                pcm_width)

    def _collect_audio(self, audio_lanes, audio_device, host_pcm,
                       pcm_width):
        """Host-sync one tick's audio: (pcm, pcm_samples, audio_errors);
        logs Ev.AUDIO_ERROR per flagged lane (scheduler.py:780-803)."""
        n = self.n
        audio_errors = np.zeros(n, bool)
        pcm = np.zeros((n, pcm_width), np.int16) if pcm_width else None
        pcm_samples = np.zeros(n, np.int32)
        for members, out, err_dev, ch in audio_device:
            outn = out.cpu().numpy()
            errn = err_dev.cpu().numpy()
            if errn.ndim > 1:     # per-frame flags -> per-lane any
                errn = errn.any(axis=tuple(range(1, errn.ndim)))
            per = ch * 128
            for i, fr in members:
                k = len(fr) * per
                pcm[i, :k] = outn[i, :k]
                pcm_samples[i] = k
                audio_lanes[i] = True
                if errn[i]:
                    audio_errors[i] = True
                    self.events.log(Ev.AUDIO_ERROR, i)
        for i, p in host_pcm.items():
            pcm[i, :len(p)] = p
            pcm_samples[i] = len(p)
            audio_lanes[i] = True
        return pcm, pcm_samples, audio_errors

    def _present(self, pics, errors):
        """Presentation bookkeeping and error containment: each decoded
        lane's session sees its PTS; an errored lane is re-seeked to
        its next random-access point (SURVEY.md 5.3)."""
        for i, p in enumerate(pics):
            if p is not None and self.sessions[i] is not None:
                self.sessions[i].on_presented(p.pts)
                if errors[i]:
                    self.events.log(Ev.LANE_ERROR, i)
                    if self.sessions[i].resync():
                        self.events.log(Ev.LANE_RESYNC, i)

    def tick_collect(self, pend: PendingTick,
                     fetch_frames: bool = True) -> TickResult:
        """Host-sync an in-flight tick and run the control-plane
        follow-ups (scheduler.py:736-808).  fetch_frames=False leaves
        y/u/v as device tensors: only the per-lane control words reach
        the host."""
        n = self.n
        if pend.presented is not None:
            with self.timers.measure("host_sync"):
                if fetch_frames:
                    y, u, v = (pend.presented[k].cpu().numpy()
                               for k in "yuv")
                else:
                    y, u, v = (pend.presented[k] for k in "yuv")
                errors = pend.info["error"].cpu().numpy()
        else:
            h, w = self.mb_h * 16, self.mb_w * 16
            y = np.zeros((n, h, w), np.uint8)
            u = np.zeros((n, h // 2, w // 2), np.uint8)
            v = np.zeros((n, h // 2, w // 2), np.uint8)
            errors = np.zeros(n, bool)
        video_lanes = np.array([p is not None for p in pend.pics])
        self._present(pend.pics, errors)
        audio_lanes = pend.audio_lanes
        pcm, pcm_samples, audio_errors = self._collect_audio(
            audio_lanes, pend.audio_device, pend.host_pcm, pend.pcm_width)
        return TickResult(video_lanes, y, u, v, pend.pts,
                          errors | pend.pre_errors, audio_lanes, pcm,
                          pcm_samples, pend.audio_starved, audio_errors)

    # -- chunked decode: K ticks, one host sync --------------------------
    def run_chunk(self, n_ticks: int, decode_audio: bool = True,
                  fetch_frames: bool = True) -> list[TickResult]:
        """Decode up to one picture per lane for `n_ticks` consecutive
        ticks in one device pass -- the lane-minor scan (K1F) and dense
        phase (K2F, K3F) per tick, frame state carried on the card, one
        host sync per chunk (scheduler.py:811-958).  Control-plane
        effects apply after the chunk; audio decodes per tick."""
        gathered = []
        batches = []
        audio = []
        for _ in range(n_ticks):
            pics, pts, pre_errors = self._gather_pictures()
            gathered.append((pics, pts, pre_errors))
            with self.timers.measure("batch_assemble"):
                batches.append(M.make_picture_batch(
                    pics, words_per_lane=self.words_per_lane,
                    max_slices=self.mb_h,
                    geometry=(self.mb_w, self.mb_h)))
            audio.append(self._submit_audio(decode_audio))
        self.events.log(Ev.DECODE_BATCH, value=sum(
            int(b["active"].sum()) for b in batches))

        with self.timers.measure("batch_assemble"):
            sls = [VS.pack_slice_rows(b, sort_rows=True) for b in batches]
            Wp = max(sl["words"].shape[1] for sl in sls)
            for sl in sls:
                sl["words"] = np.pad(
                    sl["words"], ((0, 0), (0, Wp - sl["words"].shape[1])))
            sstk = {k: np.stack([sl[k] for sl in sls]) for k in M.SCAN_KEYS}
            for k in ("intra_q", "non_intra_q", "active"):
                sstk[k] = np.stack([b[k] for b in batches])
            sstk = M.xs_to_torch(sstk, self.device)
        NS = sls[0]["span"].shape[0]
        # the long bucket absorbs every I picture's rows (span sorting
        # puts them first)
        need = max((sum(1 for p in pics
                        if p is not None and p.pic_type == 1) * self.mb_h
                    for (pics, _, _) in gathered), default=8)
        long_rows, steps_long, steps_short = bucket_policy(
            max(need, 8), NS, steps_long=2048, steps_short=512)
        with self.timers.measure("device_decode"):
            self.frames, pres, errs = _chunk_decode_pallas(
                sstk, self.frames, mb_width=self.mb_w, mb_height=self.mb_h,
                n_lanes=self.n, long_rows=long_rows, steps_long=steps_long,
                steps_short=steps_short, tables=self.tables)
        with self.timers.measure("host_sync"):
            if fetch_frames:
                ys, us, vs = (pres[k].cpu().numpy() for k in "yuv")
            else:
                ys, us, vs = (pres[k] for k in "yuv")
            errs = errs.cpu().numpy() | np.stack([sl["overflow"]
                                                  for sl in sls])

        results = []
        for t, (pics, pts, pre_errors) in enumerate(gathered):
            video_lanes = np.array([p is not None for p in pics])
            errors = errs[t].copy()
            self._present(pics, errors)
            (audio_device, host_pcm, audio_lanes, audio_starved,
             pcm_width) = audio[t]
            pcm, pcm_samples, audio_errors = self._collect_audio(
                audio_lanes, audio_device, host_pcm, pcm_width)
            results.append(TickResult(
                video_lanes, ys[t], us[t], vs[t], pts, errors | pre_errors,
                audio_lanes, pcm, pcm_samples, audio_starved,
                audio_errors))
        return results

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
        back).  Control-plane effects apply at chunk boundaries.  Needs
        Fleet(output=True)."""
        if self.output is None:
            raise ValueError("run_chunk_full needs Fleet(output=True)")
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
            xs = M.xs_to_torch({k: np.stack([x[k] for x in xs_t])
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


def _chunk_decode_pallas(sstk, frames, *, mb_width: int, mb_height: int,
                         n_lanes: int, long_rows: int, steps_long: int,
                         steps_short: int, tables: dict):
    """K ticks of the lane-minor decode (scheduler.py:1570-1594): for
    each tick the two-budget scan into lane-minor buffers (K1F) and the
    lane-minor dense phase (K2F, K3F).  sstk: [K, ...] tensors of the
    scan rows (models/mpeg1.SCAN_KEYS) and the lanes' intra_q /
    non_intra_q / active.  frames are updated in place.  Returns
    (frames, presented y/u/v [K, N, H, W], err bool[K, N])."""
    K = sstk["words"].shape[0]
    pres, errs = [], []
    for k in range(K):
        x = {key: v[k] for key, v in sstk.items()}
        coeffs, recs, nfinal, err, _it = VS.run_scan_bucketed(
            *[x[key] for key in M.SCAN_KEYS], mb_width=mb_width,
            mb_height=mb_height, n_lanes=n_lanes, long_rows=long_rows,
            steps_long=steps_long, steps_short=steps_short, chunk=128,
            lut=tables["lut"], zigzag=tables["zigzag"])
        frames, p = M.dense_compose_flat(
            coeffs, recs, nfinal, x["intra_q"], x["non_intra_q"],
            x["active"], frames, mb_width=mb_width, mb_height=mb_height,
            scale_dct=tables["scale_dct"])
        pres.append(p)
        errs.append(err)
    stacked = {key: torch.stack([p[key] for p in pres]) for key in "yuv"}
    return frames, stacked, torch.stack(errs)
