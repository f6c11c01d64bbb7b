"""Fleet scheduler: N playback sessions through batched device decode.

The port of espflix_tpu.runtime.scheduler: each lane is one
PlayerSession (control plane + bounded network pump); every tick the
fleet gathers at most one complete picture and one tick of SBC frames
per lane.  Starved or idle lanes are masked; a corrupt stream only
parks its own lane.  Two parsers: "pallas" (the port's default), the
slice scan of decode_picture_batch_sliced, and "device" (the JAX
Fleet's default), the sequential scan of decode_picture_batch.  Two
serving modes, as in the JAX package:

  * decode-only (output=False, the default; scheduler.py:270-958):
    ``tick_submit`` / ``tick_collect`` (``tick``, ``run_pipelined``)
    decode one tick -- on "pallas" K1 -> K2 -> K3, or K1F -> K2F -> K3F
    for small fleets; on "device" K1S -> K2F -> K3F -- and the SBC audio
    per (frame size, channels) group; ``run_chunk`` decodes K ticks
    (K1F -> K2F -> K3F, or K1S -> K2F -> K3F) with one host sync per
    chunk.  TickResult planes are numpy (fetch_frames=True) or device
    tensors;
  * full path (output=True; scheduler.py:1060-1379): ``run_chunk_full``
    runs K ticks of decode, both composite fields, SBC and PDM
    (runtime/chain.FullChain, kernels K1-K5) in one call; presented
    planes stay on the device, only checksums, error flags and the
    tapped lanes' signal reach the host.

Under a 'streams' mesh (parallel/mesh.py) the lanes shard in contiguous
groups: "pallas" decodes through make_sharded_pallas_decoder (K1, K2,
K3P and a torch compose per shard, tick and run_chunk), "device" through
make_sharded_decoder (tick; run_chunk runs tick by tick, as in JAX), and
run_chunk_full through chain.make_sharded_full_chunk.  Frames (and, from
the first run_chunk_full, SBC and PDM state) are Sharded; decode-only
audio stays on the mesh's first device; TickResult planes are joined on
the first device, so callers see the single-device types.

A third parser, "hybrid" (scheduler.py:160-163, 570-582), entropy-
decodes on the host with the native tokenizer (tools/oracle.py) and runs
the lane-minor dense phase (K2F, K3F) on the fleet's device; without the
tokenizer library the fleet falls back to "device", as the JAX Fleet
does.  Host gather (runtime/packed_gather.py and runtime/host_gather.py,
shared with the HostPool workers): native session feeds
(streaming/native_feed.py) pop fleet-wide in one ctypes call a pump
round, and run_chunk_full pops them straight into the batch layout
(_gather_batch_packed, timer "gather_packed") and drains their SBC rings
in one call; the other lanes take the classic gather.  On the packed
path a lane whose Streamer has a regular file open reads from a
read-only mapping of the file (streaming/title_maps.py), and those
lanes' pops, reads and feeds run in one threaded native call a tick
(streaming/native_pump.py).
Key events reach the sessions between chunks through
``Fleet.apply_keys`` (the remote's dispatch, runtime/input.dispatch_key).
run_chunk_full_pooled runs the full chain on lanes whose sessions live
in host worker processes (runtime/hostpool.HostPool).  Both full-chain
paths assemble their chunks through runtime/chunk_layout.py, in device
windows.

Frames and SBC history stay on the fleet's device (CUDA by default).

Fleet.timers (runtime/telemetry.Timers; profiler ranges ``fleet.<name>``
while a torch.profiler records) spans a full-chain chunk's host work:
gather_packed (and gather on the classic path) with gather.pop (the
mapped lanes' native pump call, and a pump round's pop of the other
lanes), gather.read (the Python reads of the lanes off the mappings, the
tick's attach check and the EOS branch) and gather.feed (a round's feed
call) inside; batch_assemble with the copy to the device, upload,
inside; chain_enqueue, the host's enqueue of the chain; host_sync with
the copies to the host, readback, inside (while tracing, after a
synchronisation, so readback times the copies alone); control, an
apply_keys call between chunks.  A pooled chunk spans pool_gather (a
tick's fan-out to the joined shards, with pool_gather.wait and
pool_gather.join inside), batch_assemble (the regroup, the stack and
upload) and present (a tick's presentation round trip), and counts
the pool's pool.worker_us, pool.worker_us_sum, pool.reply_bytes and
pool.ticks.  Fleet.counters holds the session
feed's running totals (feed.bytes_read, feed.mapped_bytes, feed.rounds,
feed.lane_ticks, feed.underruns, feed.trick_lane_ticks,
feed.slow_lane_ticks, feed.attaches) and the control's (control.keys,
control.seeks, control.seek_wait), and each full-chain chunk traced from
start to end appends a "fleet" record of its counts (with those of a
traced apply_keys call just before it), the chain a "chain" record of
its spans per stage (telemetry.traced reads them).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from espflix_tpu_torch.audio.sbc import SbcDecoder
from espflix_tpu_torch.models import mpeg1 as M
from espflix_tpu_torch.models import sbc as dsbc
from espflix_tpu_torch.ops import scan_dense as SD
from espflix_tpu_torch.ops import vlc_scan as VS
from espflix_tpu_torch.parallel import mesh as PM
from espflix_tpu_torch.runtime import chain as CH
from espflix_tpu_torch.runtime import chunk_layout as CL
from espflix_tpu_torch.runtime import host_gather as HG
from espflix_tpu_torch.runtime import packed_gather as PG
from espflix_tpu_torch.runtime import telemetry
from espflix_tpu_torch.runtime.events import Ev, EventLog
from espflix_tpu_torch.runtime.input import dispatch_key
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


_PUMP_STATES = HG.PUMP_STATES


# the mesh slice scan's row inputs, in the decoder's argument order
ROW_KEYS = M.SCAN_KEYS + ("perm",)


class Fleet:
    def __init__(self, n_lanes: int, width: int = 352, height: int = 192,
                 words_per_lane: int = 16384, mesh=None,
                 audio_frames_per_tick: int | None = None,
                 tick_rate: float = 30.0,
                 parser: str = "pallas", output: bool = False,
                 pal: bool = False, device="cuda"):
        """The fleet on one `device`, or on `mesh` (parallel/mesh.Mesh,
        a 'streams' mesh; its first device then hosts the fleet's
        single-device state).  parser: 'pallas' (the slice scan),
        'device' (the sequential scan) or 'hybrid' (the native tokenizer
        on the host, then K2F and K3F; 'device' when the tokenizer
        library cannot be built).  output=False is the decode-only fleet
        (tick, run_pipelined, run_chunk); output=True adds the
        OutputStage and the full chain (run_chunk_full, 'pallas'
        only)."""
        if parser not in ("pallas", "device", "hybrid"):
            raise ValueError(f"parser {parser!r}: 'pallas', 'device' or "
                             "'hybrid'")
        if parser == "hybrid":
            from espflix_tpu_torch.tools import oracle
            if not oracle.available():
                parser = "device"
        self.n = n_lanes
        self.width, self.height = width, height
        self.mb_w, self.mb_h = (width + 15) >> 4, (height + 15) >> 4
        self.words_per_lane = words_per_lane
        self.mesh = mesh
        self.device = torch.device(device) if mesh is None else mesh.first
        # real-time audio provisioning: at tick_rate display ticks/s
        # each lane drains 48000 / 128 / tick_rate SBC frames per tick
        # (13 at 30 fps) or its ring backs up (video.cpp:990-1004)
        if audio_frames_per_tick is None:
            audio_frames_per_tick = -(-48000 // (128 * int(tick_rate)))
        self.audio_F = audio_frames_per_tick
        self.sessions: list[PlayerSession | None] = [None] * n_lanes
        self.events = EventLog()
        self.timers = telemetry.Timers()
        # the session feed's and the control's running totals
        # (runtime/telemetry.py)
        self.counters: dict[str, int] = {}
        # the counters before a traced apply_keys call, which the next
        # chunk's "fleet" record counts from
        self._since: dict | None = None
        # lanes whose stream a key reopened (apply_keys) that have
        # presented no picture since
        self._seek_wait = np.zeros(n_lanes, bool)
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
        # the served gather: its batch buffers, title mappings and
        # policies (runtime/packed_gather.py)
        self._pg = PG.PackedGather(
            n_lanes, geometry=(width, height),
            words_per_lane=words_per_lane, mb_w=self.mb_w, mb_h=self.mb_h,
            log=self.events.log, counters=self.counters)
        # the device parser's symbol budget (scheduler.py:164-181)
        max_steps = min(words_per_lane * 32, 12000)
        if mesh is not None:
            self._decode = PM.make_sharded_decoder(
                mesh, mb_width=self.mb_w, mb_height=self.mb_h,
                max_steps=max_steps)
            self.frames = PM.shard_lane_tree(mesh, self.frames)
        else:
            def decode(*args):
                return M.decode_picture_batch(
                    *args, mb_width=self.mb_w, mb_height=self.mb_h,
                    max_steps=max_steps, tables=self.tables)
            self._decode = decode

    # -- sharded slice-scan parser (the mesh's 'pallas' path) ------------
    def _bucket_params(self, pics, lanes_per_shard: int | None = None):
        """(long_rows, steps_long, steps_short) for this tick's picture
        mix: the long bucket absorbs every I picture's rows, per shard
        when sharded (scheduler.py:196-210)."""
        n_sh = 1 if lanes_per_shard is None else \
            self.n // lanes_per_shard
        ln = lanes_per_shard or self.n
        need = 8
        for s in range(n_sh):
            n_i = sum(1 for p in pics[s * ln:(s + 1) * ln]
                      if p is not None and p.pic_type == 1)
            need = max(need, n_i * self.mb_h)
        return bucket_policy(need, ln * self.mb_h, steps_long=1024,
                             steps_short=384, floor=1)

    def _get_sharded_pallas(self, long_rows, steps_long, steps_short,
                            chunked: bool):
        """The mesh's slice-scan decoder for these budgets, per tick or
        K ticks at a time (scheduler.py:212-246)."""
        dec = PM.make_sharded_pallas_decoder(
            self.mesh, mb_width=self.mb_w, mb_height=self.mb_h,
            long_rows=long_rows, steps_long=steps_long,
            steps_short=steps_short)
        if not chunked:
            return dec

        def chunk_fn(stacked, frames):
            # stacked: [K, rows-or-lanes, ...] leaves Sharded on axis 1
            K = stacked["words"][0].shape[0]
            pres, errs = [], []
            for k in range(K):
                xs = {name: PM.Sharded(part[k] for part in v)
                      for name, v in stacked.items()}
                frames, p, info = dec(*(xs[name] for name in ROW_KEYS),
                                      xs["intra_q"], xs["non_intra_q"],
                                      xs["active"], frames)
                pres.append(p)
                errs.append(info["error"])
            n_sh = len(errs[0])
            pres = {name: PM.Sharded(
                torch.stack([p[name][i] for p in pres])
                for i in range(n_sh)) for name in "yuv"}
            errs = PM.Sharded(torch.stack([e[i] for e in errs])
                              for i in range(n_sh))
            return frames, pres, errs
        return chunk_fn

    def _pack_sharded(self, b):
        """(row arrays numpy dict incl. perm, dup) for the mesh's slice
        scan (scheduler.py:248-255): overflowed lanes are contained like
        duplicates (error -> resync)."""
        sl, dup = SD.pack_slice_rows_sharded(b, self.mesh.shape["streams"],
                                             self.mb_h)
        return sl, dup | sl["overflow"]

    _sbc_probe = staticmethod(HG.sbc_probe)

    def attach(self, lane: int, session: PlayerSession):
        self.sessions[lane] = session

    # -- control: the remote's keys between chunks ------------------------
    def apply_keys(self, keys):
        """Apply key events between chunks: `keys` maps a lane to a key
        code (runtime/input.KEY_*), each dispatched to the lane's session
        as the remote's would be (input.dispatch_key; espflix.cpp:
        941-1008), in the mapping's order.  Spans ``control``; counts the
        keys (``control.keys``) and the seeks among them, keys after
        which the lane's feed is a new object because its stream
        reopened (``control.seeks``).  A lane so reopened counts a
        lane-tick of ``control.seek_wait`` for every tick from the next
        one up to and including the tick that presents its first picture
        (run_chunk_full).  While a profiler records, the next chunk's
        "fleet" record holds these counts."""
        if self._since is None and telemetry.tracing():
            self._since = dict(self.counters)
        n_keys = n_seeks = 0
        with self.timers.measure("control"):
            for lane, key in keys.items():
                s = self.sessions[lane]
                if s is None:
                    continue
                feed = s.feed
                dispatch_key(s, key)
                n_keys += 1
                if s.feed is not feed:
                    n_seeks += 1
                    self._seek_wait[lane] = True
        HG.add_counts(self.counters, {"control.keys": n_keys,
                                      "control.seeks": n_seeks})

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

    # -- host gather (runtime/packed_gather.py) -------------------------
    @property
    def _packed(self):
        """The packed gather's batch buffers (None before its first
        tick)."""
        return self._pg.packed

    @property
    def _titles(self):
        """The packed gather's title mappings (None before its first
        tick)."""
        return self._pg.titles

    def _gather(self) -> PG.PackedGather:
        """The packed gather, with the fleet's timers, geometry and lane
        capacity as they are now (a caller may replace them after
        construction)."""
        pg = self._pg
        pg.measure = self.timers.measure
        pg.width, pg.height = self.width, self.height
        pg.words_per_lane = self.words_per_lane
        return pg

    def _gather_pictures(self):
        """One display-tick of host work (host_gather.gather_pictures):
        advance every session's clock, pull at most one complete picture
        per lane (native lanes in one pop call a pump round) and apply
        the containment policies in lane order."""
        return self._gather().pictures(self.sessions)

    def _gather_batch_packed(self):
        """The packed twin of _gather_pictures + make_picture_batch
        (packed_gather.PackedGather.gather): (batch_dict, pts,
        pre_errors), or None when the native feed is not built or no
        lane is on the fast path (the caller falls back to the classic
        gather).  The tick's feed counts go to Fleet.counters."""
        return self._gather().gather(self.sessions)

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
        decode; nothing waits for the card (scheduler.py:565-658).
        Under a mesh the presented planes and flags stay Sharded until
        tick_collect."""
        pics, pts, pre_errors = self._gather_pictures()
        presented = info = None
        active_any = any(p is not None for p in pics)
        if active_any:
            self.events.log(Ev.DECODE_BATCH,
                            value=int(sum(p is not None for p in pics)))
        if active_any and self.parser == "hybrid" and self.mesh is None:
            # the native tokenizer on the host, the dense phase (K2F,
            # K3F) on the fleet's device (scheduler.py:570-582)
            iq = np.stack([p.seq.intra_q if p is not None
                           else np.zeros(64, np.int32) for p in pics])
            nq = np.stack([p.seq.non_intra_q if p is not None
                           else np.zeros(64, np.int32) for p in pics])
            with self.timers.measure("device_decode"):
                self.frames, presented, info = \
                    M.decode_picture_batch_hybrid(
                        pics, iq, nq, self.frames, mb_width=self.mb_w,
                        mb_height=self.mb_h, tables=self.tables)
        elif active_any and self.parser == "pallas" and self.mesh is None:
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
        elif active_any and self.parser == "pallas":
            # the slice scan under the mesh: per-shard span-sorted rows
            n_sh = self.mesh.shape["streams"]
            with self.timers.measure("batch_assemble"):
                b = M.make_picture_batch(
                    pics, words_per_lane=self.words_per_lane,
                    max_slices=self.mb_h,
                    geometry=(self.mb_w, self.mb_h))
                sl, dup = self._pack_sharded(b)
                params = self._bucket_params(pics, self.n // n_sh)
                args = [PM.shard(self.mesh, sl[k], PM.LANES)
                        for k in ROW_KEYS] + [
                    PM.shard(self.mesh, b[k], PM.LANES)
                    for k in ("intra_q", "non_intra_q", "active")]
            dec = self._get_sharded_pallas(*params, chunked=False)
            with self.timers.measure("device_decode"):
                self.frames, presented, info = dec(*args, self.frames)
            pre_errors = pre_errors | dup
        elif active_any:
            # the device parser (and "hybrid" under a mesh, as in JAX):
            # the sequential scan, per shard under a mesh
            with self.timers.measure("batch_assemble"):
                b = M.make_picture_batch(
                    pics, words_per_lane=self.words_per_lane,
                    max_slices=self.mb_h)
                if self.mesh is None:
                    args = M.xs_to_torch({k: b[k] for k in M.PICTURE_KEYS},
                                         self.device).values()
                else:
                    args = [PM.shard(self.mesh, b[k], PM.LANES)
                            for k in M.PICTURE_KEYS]
            with self.timers.measure("device_decode"):
                self.frames, presented, info = self._decode(*args,
                                                            self.frames)
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
                pres = {k: self._joined(pend.presented[k]) for k in "yuv"}
                if fetch_frames:
                    y, u, v = (pres[k].cpu().numpy() for k in "yuv")
                else:
                    y, u, v = (pres[k] for k in "yuv")
                errors = self._joined(pend.info["error"]).cpu().numpy()
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

    def _joined(self, x, spec=PM.LANES):
        """A value of the fleet's decode as one tensor on the fleet's
        device: Sharded values are joined."""
        if isinstance(x, PM.Sharded):
            return PM.unshard(self.mesh, x, spec)
        return x

    # -- chunked decode: K ticks, one host sync --------------------------
    def run_chunk(self, n_ticks: int, decode_audio: bool = True,
                  fetch_frames: bool = True) -> list[TickResult]:
        """Decode up to one picture per lane for `n_ticks` consecutive
        ticks in one device pass, frame state carried on the card, one
        host sync per chunk (scheduler.py:811-958): on "pallas" the
        lane-minor scan (K1F) and dense phase (K2F, K3F) per tick, under
        a mesh the sharded slice scan (_run_chunk_mesh_pallas); on
        "device" the sequential scan (K1S, K2F, K3F), and under a mesh
        one tick at a time, as the JAX fleet does; "hybrid" runs tick by
        tick (scheduler.py:826-833).  Control-plane effects apply after
        the chunk; audio decodes per tick."""
        if self.parser == "hybrid" or (
                self.mesh is not None and self.parser != "pallas"):
            return [self.tick(decode_audio, fetch_frames=fetch_frames)
                    for _ in range(n_ticks)]
        if self.mesh is not None:
            return self._run_chunk_mesh_pallas(n_ticks, decode_audio,
                                               fetch_frames)
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
        if self.parser == "device":
            with self.timers.measure("batch_assemble"):
                stacked = M.xs_to_torch(
                    {k: np.stack([b[k] for b in batches])
                     for k in M.PICTURE_KEYS}, self.device)
            with self.timers.measure("device_decode"):
                self.frames, pres, errs = _chunk_decode_device(
                    stacked, self.frames, mb_width=self.mb_w,
                    mb_height=self.mb_h,
                    max_steps=min(self.words_per_lane * 32, 12000),
                    tables=self.tables)
            with self.timers.measure("host_sync"):
                if fetch_frames:
                    ys, us, vs = (pres[k].cpu().numpy() for k in "yuv")
                else:
                    ys, us, vs = (pres[k] for k in "yuv")
                errs = errs.cpu().numpy()
            return self._chunk_results(gathered, audio, ys, us, vs, errs)

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
        return self._chunk_results(gathered, audio, ys, us, vs, errs)

    def _chunk_results(self, gathered, audio, ys, us, vs, errs):
        """The TickResults of a decoded chunk, with the control-plane
        follow-ups of each tick in order."""
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

    def _run_chunk_mesh_pallas(self, n_ticks: int, decode_audio: bool,
                               fetch_frames: bool) -> list[TickResult]:
        """run_chunk under a mesh on the slice scan: K ticks of the
        sharded decoder, one host sync (scheduler.py:961-1058)."""
        n_sh = self.mesh.shape["streams"]
        gathered = []
        packs = []
        audio = []
        dup_any = np.zeros(self.n, bool)
        for _ in range(n_ticks):
            pics, pts, pre_errors = self._gather_pictures()
            gathered.append((pics, pts, pre_errors))
            with self.timers.measure("batch_assemble"):
                b = M.make_picture_batch(
                    pics, words_per_lane=self.words_per_lane,
                    max_slices=self.mb_h,
                    geometry=(self.mb_w, self.mb_h))
                sl, dup = self._pack_sharded(b)
            for k in ("intra_q", "non_intra_q", "active"):
                sl[k] = b[k]
            packs.append(sl)
            dup_any |= dup
            audio.append(self._submit_audio(decode_audio))
        with self.timers.measure("batch_assemble"):
            Wp = max(p["words"].shape[1] for p in packs)
            for p in packs:
                p["words"] = np.pad(p["words"],
                                    ((0, 0), (0, Wp - p["words"].shape[1])))
            stacked = PM.shard_axis1_tree(self.mesh, {
                k: np.stack([p[k] for p in packs])
                for k in ROW_KEYS + ("intra_q", "non_intra_q", "active")})
        self.events.log(Ev.DECODE_BATCH, value=sum(
            int(p["active"].sum()) for p in packs))
        per_tick = [self._bucket_params(pics, self.n // n_sh)
                    for (pics, _, _) in gathered]
        params = tuple(max(p[j] for p in per_tick) for j in range(3))
        chunk_fn = self._get_sharded_pallas(*params, chunked=True)
        with self.timers.measure("device_decode"):
            self.frames, pres, errs = chunk_fn(stacked, self.frames)
        with self.timers.measure("host_sync"):
            pres = {k: self._joined(pres[k], PM.AXIS1) for k in "yuv"}
            if fetch_frames:
                ys, us, vs = (pres[k].cpu().numpy() for k in "yuv")
            else:
                ys, us, vs = (pres[k] for k in "yuv")
            errs = self._joined(errs, PM.AXIS1).cpu().numpy() \
                | dup_any[None, :]
        return self._chunk_results(gathered, audio, ys, us, vs, errs)

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
        """One tick of SBC frames as chain inputs
        (host_gather.gather_audio_arrays); the first discovered 16-block
        lane fixes the fleet's channel count.  Returns (words, active,
        n_valid, starved, channels)."""
        words, act, nval, starved, ch, self._aud_op = \
            HG.gather_audio_arrays(self.sessions, F, self._aud_op,
                                   self.events.log)
        return words, act, nval, starved, ch

    def _slide_and_taps(self, xs_t, tap_lanes):
        """(scrolled, slide planes or None, tap count, tap_idx) of a
        full-chain chunk: scrolled when a lane of the chunk slides and
        the OutputStage holds outgoing planes to slide against."""
        scrolled = any((x["hscroll"] != 0).any() for x in xs_t)
        sld = self.output.slide_planes()
        slide = None
        if scrolled and sld is not None:
            slide = tuple(torch.from_numpy(s).to(self.device) for s in sld)
        else:
            scrolled = False
        tap_idx = torch.tensor(list(tap_lanes) or [0], dtype=torch.int32,
                               device=self.device)
        return scrolled, slide, len(tap_lanes), tap_idx

    @staticmethod
    def _chain_outs_to_host(outs, tap: int):
        """The chain's per-tick outputs on the host: (err, field_sum,
        pdm_sum, audio_err, tap_fields, tap_pdm), the taps None when
        nothing is tapped."""
        return tuple(outs[k].cpu().numpy() for k in (
            "err", "field_sum", "pdm_sum", "audio_err")) + tuple(
            outs[k].cpu().numpy() if tap else None
            for k in ("tap_fields", "tap_pdm"))

    # -- full-path chunk: decode + composite + SBC + PDM on device -------
    def run_chunk_full(self, n_ticks: int, tap_lanes=(),
                       steps_long: int = 1024, steps_short: int = 384,
                       chunk: int = 128) -> list[TickResult]:
        """K ticks of the complete reference loop in one chain call:
        decode + both composite fields (real per-lane OSD/progress/
        slide/beep/starved state) + SBC + delta-sigma PDM.  Presented
        planes, fields and PDM stay on the device (checksums in the
        TickResult; tap_lanes get their full DAC fields and PDM words
        back).  Native lanes pop straight into the batch layout
        (_gather_batch_packed, timer "gather_packed"), the rest through
        the classic gather ("gather", "batch_assemble").  The chunk is
        laid out in device windows by runtime/chunk_layout.py.
        Control-plane effects apply at chunk boundaries.  Needs
        Fleet(output=True) on the 'pallas' parser.  Under a mesh the
        chain runs per shard (chain.make_sharded_full_chunk) on rows
        packed per shard, the budgets sized for the worst shard; the
        first call moves the SBC and PDM state onto the mesh."""
        if self.output is None:
            raise ValueError("run_chunk_full needs Fleet(output=True)")
        if self.parser != "pallas":
            raise ValueError("the full chain runs on the 'pallas' parser")
        n_sh = self.mesh.shape["streams"] if self.mesh is not None else 0
        F = self.audio_F
        counted = (self._since or dict(self.counters)) \
            if telemetry.tracing() else None
        self._since = None
        gathered = []
        xs_t = []
        dup_any = np.zeros(self.n, bool)
        need_long = 8
        ch = 1
        for _ in range(n_ticks):
            with self.timers.measure("gather_packed"):
                g = self._gather_batch_packed()
            if g is not None:
                b, pts, pre_errors = g
            else:
                with self.timers.measure("gather"):
                    pics, pts, pre_errors = self._gather_pictures()
                with self.timers.measure("batch_assemble"):
                    b = M.make_picture_batch(
                        pics, words_per_lane=self.words_per_lane,
                        max_slices=self.mb_h,
                        geometry=(self.mb_w, self.mb_h))
            with self.timers.measure("batch_assemble"):
                # the long symbol bucket absorbs every I picture's rows
                # (per shard under a mesh: the worst shard's)
                is_i = (b["pic_type"] == 1) & b["active"]
                if n_sh:
                    need_long = max(need_long, int(
                        is_i.reshape(n_sh, -1).sum(axis=1).max())
                        * self.mb_h)
                    sl, dup = SD.pack_slice_rows_sharded(
                        b, n_sh, self.mb_h, device_windows=True)
                    perm = sl["perm"]
                    dup = dup | sl["overflow"]
                else:
                    need_long = max(need_long, int(is_i.sum()) * self.mb_h)
                    sl = VS.pack_slice_rows(b, sort_rows=True,
                                            device_windows=True)
                    perm, dup = SD.row_perm(sl["lane_of_row"], sl["rows"],
                                            sl["alive"], self.n, self.mb_h)
            dup_any |= dup
            with self.timers.measure("gather"):
                *audio, ch = self._gather_audio_arrays(F)
                self._update_osd()
                snap = self.output.tick_state(F)
            xs_t.append(CL.tick_inputs(sl, perm, b, snap, audio))
            gathered.append((b["active"].copy(), pts, pre_errors,
                             audio[3]))

        with self.timers.measure("batch_assemble"):
            stacked, win = CL.stack_chunk(xs_t)
            with self.timers.measure("upload"):
                xs = M.xs_to_torch(stacked, self.device) if not n_sh \
                    else PM.shard_axis1_tree(self.mesh, stacked)
        self.events.log(Ev.DECODE_BATCH, value=sum(
            int(x["active"].sum()) for x in xs_t))

        scrolled, slide, tap, tap_idx = self._slide_and_taps(xs_t, tap_lanes)

        long_rows, steps_long, steps_short = bucket_policy(
            need_long, (self.n // max(n_sh, 1)) * self.mb_h,
            steps_long=steps_long, steps_short=steps_short)
        run_kw = dict(mb_width=self.mb_w, mb_height=self.mb_h,
                      long_rows=long_rows, steps_long=steps_long,
                      steps_short=steps_short, tap=tap, channels=ch,
                      return_planes=True, win=win,
                      chunk=min(chunk, steps_short), scrolled=scrolled)
        with self.timers.measure("chain_enqueue"):
            if n_sh:
                # the first call moves the lane-major carries onto the
                # mesh (shard_lane_tree keeps Sharded values as they are)
                self.sbc_state = PM.shard_lane_tree(self.mesh,
                                                    self.sbc_state)
                self.output.pdm_state = PM.shard_lane_tree(
                    self.mesh, self.output.pdm_state)
                fn = CH.make_sharded_full_chunk(
                    self.mesh, n_lanes=self.n, n_aud_frames=F,
                    pal=self.pal, **run_kw)
                (self.frames, self.sbc_state, self.output.pdm_state,
                 outs) = fn(xs, self.frames, self.sbc_state,
                            self.output.pdm_state, tap_idx, slide)
            else:
                (self.frames, self.sbc_state, self.output.pdm_state,
                 outs) = self.chain(
                    xs, self.frames, self.sbc_state, self.output.pdm_state,
                    tap_idx, n_lanes=self.n, slide=slide, **run_kw)

        with self.timers.measure("host_sync"):
            if telemetry.tracing():
                telemetry.sync(*(self.mesh.device_list() if n_sh
                                 else [self.device]))
            with self.timers.measure("readback"):
                outs = {k: self._joined(v, PM.AXIS1)
                        for k, v in outs.items()}
                errs, fsum, psum, audio_errs, tap_f, tap_p = \
                    self._chain_outs_to_host(outs, tap)
            errs = errs | dup_any[None, :]

        results = []
        for t, (video_lanes, pts, pre_errors, starved) in \
                enumerate(gathered):
            # lanes waiting for their first picture since a seek, those
            # that present it now included
            HG.add_counts(self.counters,
                          {"control.seek_wait": self._seek_wait.sum()})
            self._seek_wait[video_lanes] = False
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
        self._record_chunk(n_ticks, counted)
        return results

    def _record_chunk(self, n_ticks: int, counted: dict | None):
        """A full-chain chunk's "fleet" record (runtime/telemetry.py):
        its feed counts, when a profiler recorded from its start
        (`counted`, the counters then) to its end."""
        if counted is not None and telemetry.tracing():
            telemetry.record("fleet", n_ticks,
                             counters=telemetry.delta(self.counters, counted))

    # -- the full chain fed by a HostPool --------------------------------
    def run_chunk_full_pooled(self, pool, n_ticks: int, tap_lanes=(),
                              steps_long: int = 1024,
                              steps_short: int = 384,
                              chunk: int = 128) -> list[TickResult]:
        """run_chunk_full with the sessions on a HostPool
        (runtime/hostpool.py; scheduler.py:1382-1552): the per-tick
        control plane (pump, demux, segmentation, slice packing) runs in
        the pool's worker processes, each through the packed gather
        (runtime/packed_gather.py); this process concatenates their
        shard blobs (span ``pool_gather``, with ``pool_gather.wait`` and
        ``pool_gather.join`` inside), regroups the per-worker
        span-sorted rows into the global long and short buckets
        (chunk_layout.regroup_workers, in ``batch_assemble``) and runs
        the same FullChain on the fleet's device, with the OSD, beep and
        slide state of this fleet's OutputStage (drive it via pool.call
        and fleet.output).  Presentation and resync route back to the
        workers after the chunk (span ``present``, the chunk's one round
        trip).  Presented planes stay on the device, as in
        run_chunk_full.  Fleet.counters adds the workers' feed counts
        and the pool's (``pool.worker_us``, ``pool.worker_us_sum``,
        ``pool.reply_bytes``, ``pool.ticks``)."""
        assert self.output is not None and self.parser == "pallas" \
            and self.mesh is None, \
            "run_chunk_full_pooled needs Fleet(output=True, parser=" \
            "'pallas') without a mesh"
        F = self.audio_F
        mbh = self.mb_h
        NS = self.n * mbh
        counted = dict(self.counters) if telemetry.tracing() else None
        snaps = []
        meta = []
        need_long = 8
        for _ in range(n_ticks):
            with self.timers.measure("pool_gather"):
                g = pool.gather_tick(F, self.timers.measure)
            HG.add_counts(self.counters, g["feed"])
            HG.add_counts(self.counters, g["pool"])
            for ev, lane, value in g["ev_pic"] + g["ev_aud"]:
                self.events.log(Ev(ev), lane, value=value)
            need_long = max(need_long, g["n_i"] * mbh)
            meta.append(g)
            snaps.append(self.output.tick_state(F))

        long_rows, steps_long, steps_short = bucket_policy(
            need_long, NS, steps_long=steps_long, steps_short=steps_short)

        with self.timers.measure("batch_assemble"):
            xs_t = []
            for g, snap in zip(meta, snaps):
                r = CL.regroup_workers(g, pool.w, pool.ln, mbh)
                xs_t.append(CL.tick_inputs(
                    r, r["perm"], g, snap,
                    [g[k] for k in CL.AUDIO_KEYS]))
            stacked, win = CL.stack_chunk(xs_t)
            with self.timers.measure("upload"):
                xs = M.xs_to_torch(stacked, self.device)

        self.events.log(Ev.DECODE_BATCH, value=sum(
            int(g["active"].sum()) for g in meta))
        scrolled, slide, tap, tap_idx = self._slide_and_taps(xs_t, tap_lanes)
        ops = [g["aud_op"] for g in meta if g["aud_op"]]
        ch = ops[0] if ops else 1

        with self.timers.measure("chain_enqueue"):
            (self.frames, self.sbc_state, self.output.pdm_state,
             outs) = self.chain(
                xs, self.frames, self.sbc_state, self.output.pdm_state,
                tap_idx, mb_width=self.mb_w, mb_height=self.mb_h,
                n_lanes=self.n, long_rows=long_rows, steps_long=steps_long,
                steps_short=steps_short, tap=tap, channels=ch,
                return_planes=True, win=win,
                chunk=min(chunk, steps_short), scrolled=scrolled,
                slide=slide)

        with self.timers.measure("host_sync"):
            if telemetry.tracing():
                telemetry.sync(self.device)
            with self.timers.measure("readback"):
                errs, fsum, psum, audio_errs, tap_f, tap_p = \
                    self._chain_outs_to_host(outs, tap)

        errors = [errs[t] | g["pre_errors"] for t, g in enumerate(meta)]
        with self.timers.measure("present"):
            resynced = [set(r) for r in pool.present(
                [g["pts"] for g in meta], errors)]
        results = []
        for t, g in enumerate(meta):
            for i in np.flatnonzero(g["video"] & errors[t]):
                self.events.log(Ev.LANE_ERROR, int(i))
                if i in resynced[t]:
                    self.events.log(Ev.LANE_RESYNC, int(i))
            for i in np.flatnonzero(audio_errs[t]):
                self.events.log(Ev.AUDIO_ERROR, int(i))
            results.append(TickResult(
                g["video"], outs["y"][t], outs["u"][t], outs["v"][t],
                g["pts"], errors[t], audio_lanes=g["aud_act"], pcm=None,
                pcm_samples=None, audio_starved=g["starved"],
                audio_errors=audio_errs[t],
                field_sum=fsum[t], pdm_sum=psum[t],
                tap_fields=tap_f[t] if tap else None,
                tap_pdm=tap_p[t] if tap else None))
        self._record_chunk(n_ticks, counted)
        return results


def _chunk_decode_device(stacked, frames, *, mb_width: int, mb_height: int,
                         max_steps: int, tables: dict):
    """K ticks of the device parser (scheduler.py:1551-1567): for each
    tick the sequential scan (K1S) and the lane-minor dense phase (K2F,
    K3F).  stacked: [K, ...] tensors of models/mpeg1.PICTURE_KEYS.
    frames are updated in place.  Returns (frames, presented y/u/v
    [K, N, H, W], err bool[K, N])."""
    K = stacked["words"].shape[0]
    pres, errs = [], []
    for k in range(K):
        frames, p, info = M.decode_picture_impl(
            *[stacked[key][k] for key in M.PICTURE_KEYS], frames,
            mb_width=mb_width, mb_height=mb_height, max_steps=max_steps,
            tables=tables)
        pres.append(p)
        errs.append(info["error"])
    stacked_p = {key: torch.stack([p[key] for p in pres]) for key in "yuv"}
    return frames, stacked_p, torch.stack(errs)


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
