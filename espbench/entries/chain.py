"""Entry `chain`: the per-tick device chain, fed from the device.

The window drives `runtime/chain.FullChain` (one module for the run, as
`Fleet.run_chunk_full` keeps one) over a chunk of K ticks that set-up
built and uploaded once, in the layout the Fleet serves (device
windows: per-lane words and row bases, `bucket_policy`'s budgets), with
the presented planes returned and the checked lanes tapped; each
chunk's outputs stay on the card and only its error flags come to the
host, which is the chunk's synchronisation.  Closed loop: the next
chunk starts when the last one's flags are on the host.
The chunk replays, so each lane's GOP loop continues seamlessly.

Checked after the window (reference/media, reference/composite,
reference/audio), all against what the reference works out from the
streams and the lanes' schedule:

- the last chunk of the window: every lane's presented planes, every
  lane's field checksum, the checked lanes' whole fields, every lane's
  error flags;
- the checked lanes' PDM words and checksums in the warm-up chunk, from
  the initial state, and in the window's last two chunks, each from the
  program's modulator state at its start (the reference cannot work
  that state out without running every tick before it), and the state
  that the reference reaches at the end of the second-to-last chunk
  against the program's at the start of the last: the carry across a
  chunk boundary.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from espflix_tpu_torch.models import mpeg1 as M
from espflix_tpu_torch.models import sbc as dsbc
from espflix_tpu_torch.ops import delta_sigma as DS
from espflix_tpu_torch.ops import scan_dense as SD
from espflix_tpu_torch.ops import vlc_scan as VS
from espflix_tpu_torch.runtime import chain as CH
from espflix_tpu_torch.runtime.scheduler import bucket_policy

from espbench import roofline, stats, workload
from espbench.reference import audio as RA
from espbench.reference import composite as RC
from espbench.reference import media
from espbench.trace import Profile, StageTimer

HOST_KEYS = ("err", "audio_err", "field_sum", "pdm_sum", "tap_fields",
             "tap_pdm")
BLOCK = 1024            # lanes a block of the reference's composite


def build_xs(t: workload.DeviceFed, mb_h: int):
    """The program's inputs of one chunk, derived as Fleet.run_chunk_full
    derives them: (xs numpy dict, win, need_long)."""
    pics = [M.parse_es(s.es)[1] for s in t.streams]
    wpl = max(max((len(p.payload) + 3) // 4 + 4 for p in ps) for ps in pics)
    xs_t, need_long = [], 8
    F = len(t.streams[0].audio[0])
    words = np.stack([np.stack([dsbc.frames_to_words(np.frombuffer(
        b"".join(s.audio[j]), np.uint8).reshape(1, F, -1))[0]
        for j in range(t.K)]) for s in t.streams])    # [S, K, F, Wa]
    for k in range(t.K):
        pk = t.picture(k)
        sel = [pics[s][j] for s, j in zip(t.stream_of, pk)]
        b = M.make_picture_batch(sel, words_per_lane=wpl, max_slices=mb_h)
        need_long = max(need_long, int(((b["pic_type"] == 1)
                                        & b["active"]).sum()) * mb_h)
        sl = VS.pack_slice_rows(b, sort_rows=True, device_windows=True)
        perm, dup = SD.row_perm(sl["lane_of_row"], sl["rows"], sl["alive"],
                                t.lanes, mb_h)
        if dup.any() or sl["overflow"].any():
            raise RuntimeError("the chunk's rows do not fit")
        x = {key: sl[key] for key in CH.DECODE_KEYS_DW[:9]}
        x["win"] = sl["win"]
        x["perm"] = perm
        for key in ("intra_q", "non_intra_q", "active"):
            x[key] = b[key]
        x.update(osd=t.osd[k], blend=t.blend[k], progress=t.progress[k],
                 parity=t.parity[k], beep_left=t.beep_left[k],
                 aud_words=words[t.stream_of, pk],
                 aud_act=np.ones(t.lanes, bool),
                 aud_nval=np.full(t.lanes, F, np.int32),
                 starved=t.starved[k])
        xs_t.append(x)
    win = max(x.pop("win") for x in xs_t)
    Wm = max(x["lane_words"].shape[1] for x in xs_t)
    for x in xs_t:
        x["lane_words"] = np.pad(x["lane_words"],
                                 ((0, 0), (0, Wm - x["lane_words"].shape[1])))
    return {k: np.stack([x[k] for x in xs_t]) for k in xs_t[0]}, win, \
        need_long


class Cell:
    """One run of a chain cell: set-up in the constructor (inputs,
    upload, one warm chunk), then `window`, `release` and `check`."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device,
                 trace: bool):
        self.cfg, self.mix, self.device = cfg, mix, device
        self.pal = cfg["standard"] == "pal"
        self.F = cfg["frames_per_tick"]
        v = cfg["video"]
        self.mb_w, self.mb_h = (v["width"] + 15) >> 4, (v["height"] + 15) >> 4
        self.t = t = workload.device_fed(seed, cfg, mix)
        self.ref = None
        if trace:
            # the parse that counts the bytes is the reference's own
            self.ref = media.decode_all([s.es for s in t.streams])
        xs, win, need_long = build_xs(t, self.mb_h)
        self.xs = M.xs_to_torch(xs, device)
        long_rows, steps_long, steps_short = bucket_policy(
            need_long, t.lanes * self.mb_h, steps_long=1024,
            steps_short=384)
        self.tap_idx = torch.as_tensor(t.checked, dtype=torch.int32,
                                       device=device)
        self.kw = dict(mb_width=self.mb_w, mb_height=self.mb_h,
                       n_lanes=t.lanes, long_rows=long_rows,
                       steps_long=steps_long, steps_short=steps_short,
                       tap=len(t.checked), channels=cfg["audio"]["channels"],
                       return_planes=True, win=win,
                       chunk=min(128, steps_short))
        self.chain = CH.FullChain(pal=self.pal, n_aud_frames=self.F,
                                  device=device)
        self.frames = M.init_frame_state(t.lanes, self.mb_w * 16,
                                         self.mb_h * 16, device)
        self.sbc = dsbc.init_state(t.lanes, device)
        self.ds = DS.init_state(t.lanes, device)
        # the warm chunk: every shape of the window, from the initial state
        outs, _flags = self._chunk()
        self.warm = _host(outs)
        # (chunk, modulator state at its start, tapped PDM, PDM checksums)
        # of the last two chunks; the warm chunk's state is the initial one
        self.recent = [(0, None, self.warm["tap_pdm"],
                        self.warm["pdm_sum"])]

    def _chunk(self, timer=None):
        """One chunk on the program: (device outs, host error flags)."""
        (self.frames, self.sbc, self.ds, outs) = self.chain(
            self.xs, self.frames, self.sbc, self.ds, self.tap_idx,
            timer=timer, **self.kw)
        with torch.profiler.record_function("espbench.host_sync"):
            flags = (outs["err"] | outs["audio_err"]).cpu().numpy()
        return outs, flags

    def window(self, seconds: float, profile: Profile | None = None):
        """Chunks until `seconds` have passed; returns the window's
        numbers (see run.py)."""
        lanes, K = self.t.lanes, self.t.K
        chunks = failed = 0
        t0 = time.perf_counter()
        while True:
            if profile is not None and chunks == 1:
                profile.start()
            ds_in = self.ds
            with torch.profiler.record_function("espbench.enqueue"):
                outs, flags = self._chunk()
            chunks += 1
            self.recent = [self.recent[-1], (chunks, ds_in, outs["tap_pdm"],
                                              outs["pdm_sum"])]
            failed += int(flags.sum())
            if profile is not None and chunks == 1 + self.mix["trace_chunks"]:
                profile.stop()
                profile.ticks = self.mix["trace_chunks"] * K
            if time.perf_counter() - t0 >= seconds and \
                    (profile is None or profile.done):
                break
        window_s = time.perf_counter() - t0
        self.last = outs
        res = dict(attempted=chunks * K * lanes, failed=failed,
                   window_s=window_s,
                   e2e={"chain_streams": stats.streams(
                       chunks * K * lanes, window_s, self.cfg["tick_hz"])})
        if profile is not None:
            timer = StageTimer()
            self._chunk(timer)
            res["stages"] = timer.totals_s()
            res["bytes"] = roofline.chunk_bytes(self.ref, self.t, self.cfg) \
                * self.mix["trace_chunks"]
        return res

    def release(self):
        """Drop the program's state; keep what the check reads."""
        outs = self.last
        chk = torch.as_tensor(self.t.checked)
        self.pdm_chunks = {0: (None, self.warm["tap_pdm"],
                               self.warm["pdm_sum"])}
        for c, ds_in, tap_pdm, pdm_sum in self.recent[-2:]:
            if c:
                self.pdm_chunks[c] = (ds_in[chk].cpu().numpy(),
                                      tap_pdm.cpu().numpy(),
                                      pdm_sum.cpu().numpy())
        self.planes = {p: outs[p] for p in "yuv"}
        self.host = _host(outs)
        del self.xs, self.chain, self.frames, self.sbc, self.ds, self.last
        del self.recent
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def substitute_control(self):
        """Put the control in the program's place: the last chunk's planes,
        field checksums and tapped fields are what the reference presents
        with its IDCT in float32 (reference/refdec.idct_float32)."""
        t, dev = self.t, self.device
        low = _planes_of(media.decode_all([s.es for s in t.streams],
                                          control=True), t, dev)
        s_of = torch.as_tensor(t.stream_of, device=dev)
        self.planes = {p: torch.stack([low[p][s_of, torch.as_tensor(
            t.picture(k), device=dev)] for k in range(t.K)]) for p in "yuv"}
        self.host["field_sum"], self.host["tap_fields"] = reference_fields(
            t, self.pal, lambda k, sl: tuple(self.planes[p][k, sl]
                                             for p in "yuv"), dev)

    def check(self) -> dict:
        """{name: (value, limit)}: each number counts the values that
        differ from the reference; every limit is 0."""
        t = self.t
        ref = self.ref or media.decode_all([s.es for s in t.streams])
        want = _planes_of(ref, t, self.device)
        out = compare_video(t, self.pal, want, self.device,
                            lambda k, sl: tuple(self.planes[p][k, sl]
                                                for p in "yuv"),
                            self.host["field_sum"], self.host["tap_fields"])
        out["flags"] = int((self.host["err"] | self.host["audio_err"]).sum())
        out.update(self._check_pdm())
        return {name: (v, 0) for name, v in out.items()}

    def _check_pdm(self) -> dict:
        """The checked lanes' PDM words and checksums in the warm-up chunk
        (from the initial state) and the window's last two chunks (each
        from the program's state at its start), as one batch of lanes,
        and the carry from the second-to-last chunk into the last."""
        t, c = self.t, self.t.checked
        pcm = [media.tick_pcm(s.audio) for s in t.streams]
        n = len(c)
        order = sorted(self.pdm_chunks)
        state = np.concatenate([np.zeros((n, 3), np.int32) if ch == 0 else
                                self.pdm_chunks[ch][0] for ch in order])
        m = len(order)
        diff = dsum = 0
        for k in range(t.K):
            pk = t.picture(k)[c]
            tick = [np.stack([pcm[s][fresh][j] for s, j in
                              zip(t.stream_of[c], pk)]) for fresh in (0, 1)]
            words, state = RA.audio_out(
                np.concatenate([tick[ch == 0 and k == 0] for ch in order]),
                state, np.tile(t.beep_left[k, c], m), np.ones(m * n, bool),
                np.tile(t.starved[k, c], m))
            got = np.concatenate([self.pdm_chunks[ch][1][k] for ch in order])
            diff += int((words != got).sum())
            sums = _wrap32(words.astype(np.int64).sum(axis=1))
            dsum += int((sums != np.concatenate(
                [self.pdm_chunks[ch][2][k, c] for ch in order])).sum())
        last = order[-1]
        prev = order.index(last - 1)
        carried = state[prev * n:(prev + 1) * n]
        return dict(pdm=diff, pdm_sum=dsum, pdm_carry=int(
            (carried != self.pdm_chunks[last][0]).sum()))


def reference_fields(t, pal: bool, planes, dev):
    """(field_sum int32[K, lanes], tap_fields uint8[K, checked, ...]) that
    the reference's composite makes of the planes `planes(k, lane
    slice)` -> (y, u, v) under the lanes' output state."""
    state = [torch.as_tensor(a, device=dev)
             for a in (t.parity, t.osd, t.blend, t.progress)]
    chk = torch.as_tensor(t.checked, device=dev)
    sums, taps = [], []
    for k in range(t.K):
        row = []
        for lo in range(0, t.lanes, BLOCK):
            sl = slice(lo, lo + BLOCK)
            row.append(RC.field_pair_parts(
                *planes(k, sl), *(a[k, sl] for a in state),
                pal=pal)[2].cpu().numpy())
        sums.append(np.concatenate(row))
        tp = [torch.cat([planes(k, slice(int(i), int(i) + 1))[n]
                         for i in t.checked]) for n in range(3)]
        taps.append(RC.field_pair(*tp, *(a[k, chk] for a in state),
                                  pal=pal)[0].cpu().numpy())
    return np.stack(sums), np.stack(taps)


def compare_video(t, pal: bool, want: dict, dev, got, field_sum,
                  tap_fields) -> dict:
    """Counts of what differs from the reference in one chunk: every
    lane's presented planes (`got(k, lane slice)` -> y, u, v), every
    lane's field checksum and the checked lanes' whole fields."""
    out = dict(planes=0, field_sum=0, fields=0)
    chk = torch.as_tensor(t.checked, device=dev)
    s_of = torch.as_tensor(t.stream_of, device=dev)
    state = [torch.as_tensor(a, device=dev)
             for a in (t.parity, t.osd, t.blend, t.progress)]
    for k in range(t.K):
        pk = torch.as_tensor(t.picture(k), device=dev)
        for lo in range(0, t.lanes, BLOCK):
            sl = slice(lo, lo + BLOCK)
            w = [want[p][s_of[sl], pk[sl]] for p in "yuv"]
            g = got(k, sl)
            out["planes"] += int(sum((a != b).sum() for a, b in zip(g, w)))
            _a, _s, fs = RC.field_pair_parts(*w, *(a[k, sl] for a in state),
                                             pal=pal)
            out["field_sum"] += int((fs.cpu().numpy()
                                     != field_sum[k, sl]).sum())
        ff, _fs = RC.field_pair(*(want[p][s_of[chk], pk[chk]] for p in "yuv"),
                                *(a[k, chk] for a in state), pal=pal)
        out["fields"] += int((ff.cpu().numpy() != tap_fields[k]).sum())
    return out


def _planes_of(ref, t, dev) -> dict:
    """The reference's pictures on `dev`: {p: uint8[S, K, H, W]}."""
    return {p: torch.as_tensor(np.stack([np.stack([pics[j][i]
                                                   for j in range(t.K)])
                                         for pics, _st in ref]),
                               device=dev)
            for i, p in enumerate("yuv")}


def _host(outs) -> dict:
    return {k: outs[k].cpu().numpy() for k in HOST_KEYS}


def _wrap32(x: np.ndarray) -> np.ndarray:
    return ((x + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int64)
