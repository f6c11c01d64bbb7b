"""Output stage: per-lane OSD, flip animation, beep, fields and PDM.

The port of espflix_tpu.runtime.output.OutputStage: the per-lane OSD
state (time readout, progress bar, fade countdown), the buffer-flip
slide animator and the key-feedback beep, kept on the host (numpy)
exactly as the reference ISR keeps them (video.cpp:1077-1198,
espflix.cpp:862-884); ``tick_state``, the per-tick snapshot the device
chain (runtime/chain.py) consumes; and the per-field path outside the
chain:

  * ``synthesize(y, u, v)``: one composite field per lane at parity
    frame_counter & 1 -- ops/composite.synthesize_field (K4, field 0 of
    the pair laid into its template), after the flip animation's scroll
    blit when a lane slides -- as a uint8[N, L, W] tensor on the stage's
    device;
  * ``modulate(pcm, starved)``: beep substitution, then K5
    (ops/delta_sigma.modulate), starved lanes 0xAAAA with their
    modulator state kept.

The modulator state ``pdm_state`` is an int32[N, 3] tensor on the
stage's device.  CPU stages take the kernels' plain forms.
"""

from __future__ import annotations

import numpy as np
import torch

from espflix_tpu_torch.video.render import PAUSE, PLAY, FFWD, RWND, show_time
from espflix_tpu_torch.ops import composite as C
from espflix_tpu_torch.ops import delta_sigma as DS

# key-feedback beep: the reference's 32-sample sine (negated-sin phase,
# espflix.ino:109-120), played at >>2 amplitude for 5 audio frames (128
# samples each).  Transcribed verbatim for bit parity (its rounding
# differs from round() by 1 LSB on some taps).
_S = [0, 6392, 12539, 18204, 23169, 27244, 30272, 32137, 32767]
_SIN32 = np.array(
    [-_S[i] for i in range(9)] + [-_S[16 - i] for i in range(9, 16)]
    + [_S[i - 16] for i in range(16, 25)]
    + [_S[32 - i] for i in range(25, 32)], np.int32)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class OutputStage:
    def __init__(self, n_lanes: int, pal: bool = False, device="cuda"):
        self.n = n_lanes
        self.pal = pal
        self.osd = np.zeros((n_lanes, 16, 80), np.uint8)
        self.blend = np.zeros(n_lanes, np.int32)
        self.progress = np.zeros(n_lanes, np.int32)
        self.frame_counter = np.zeros(n_lanes, np.int64)
        self.last_seconds = np.full(n_lanes, -1, np.int64)
        self.device = torch.device(device)
        self.pdm_state = DS.init_state(n_lanes, self.device)
        self.beep_frames = np.zeros(n_lanes, np.int32)
        # buffer-flip slide animation (video.cpp:936-943, 1077-1088):
        # per-lane ease counter, current hscroll, and the "other
        # buffer" snapshot the new frame slides against
        self.animate_index = np.zeros(n_lanes, np.int32)
        self.hscroll = np.zeros(n_lanes, np.int32)
        self._slide = None               # (y, u, v) snapshots (numpy)
        self._last = None                # last planes synthesized
        # the snapshots on the device for synthesize(), and the lanes
        # start_slide changed since they were uploaded
        self._slide_dev = None
        self._slide_dirty: set[int] = set()

    # -- flip animation (video.cpp:1077-1088, 1163-1178) ----------------
    def start_slide(self, lane: int, direction: int, prev=None):
        """Begin the ease-in/out horizontal slide on a buffer flip.

        direction: the reference's flush_picture mode -- 2 slides the
        new frame in from the left (load_poster dir < 0), 3 from the
        right (espflix.cpp:1060-1069).  prev: optional (y, u, v) for
        the outgoing frame (numpy or tensors); defaults to the last
        synthesized planes.  Only the lane's rows are copied.
        """
        if prev is None:
            prev = self._last
        if prev is None:
            return
        if self._slide is None:
            self._slide = tuple(np.zeros(tuple(p.shape), _host(p[:0]).dtype)
                                for p in prev)
        for buf, p in zip(self._slide, prev):
            buf[lane] = _host(p[lane])
        self._slide_dirty.add(int(lane))
        self.animate_index[lane] = -16 if direction == 2 else 16
        self._animate_step(lane)         # flip calls animate() once

    def _animate_step(self, lane=None):
        """One per-field animator update (video.cpp:1078-1088)."""
        sel = np.zeros(self.n, bool)
        if lane is None:
            sel[:] = True
        else:
            sel[lane] = True
        idx = self.animate_index
        new = np.where(idx < 0, idx + 1, np.where(idx > 0, idx - 1, 0))
        hs = np.where(new < 0, -C.EASE[-new],
                      np.where(new > 0, C.EASE[new], 0)).astype(np.int32)
        hs = np.where(idx == 0, 0, hs)
        self.animate_index = np.where(sel, new, idx)
        self.hscroll = np.where(sel, hs, self.hscroll)

    def beep(self, lane: int):
        """Queue the 5-frame key-feedback beep (espflix.ino:116-120)."""
        self.beep_frames[lane] = 5

    # -- OSD state (espflix.cpp:862-884) --------------------------------
    def show_progress(self, lane: int, t: int = 180):
        self.blend[lane] = t

    def hide_progress(self, lane: int):
        self.blend[lane] = 0

    def update_progress(self, lane: int, main_pts: int, total_pts: int,
                        state_icon: int = PLAY):
        seconds = main_pts // 90000
        if seconds != self.last_seconds[lane]:
            show_time(self.osd[lane], int(seconds), state_icon)
            self.last_seconds[lane] = seconds
        if total_pts > 0:
            self.progress[lane] = int(
                main_pts * C.OSD_PROGRESS_W // total_pts)

    @staticmethod
    def icon_for(speed: int, paused: bool) -> int:
        if speed == 0:
            return PAUSE if paused else PLAY
        return FFWD if speed > 0 else RWND

    # -- fleet-chain state capture (runtime/chain.py) -------------------
    def tick_state(self, n_aud_frames: int) -> dict:
        """Capture this tick's per-lane OSD/animation/beep state for
        the device chain, then advance the host counters by one frame
        pair (two fields: blend fades and the slide animator step once
        per field, video.cpp:1190-1196) and by n_aud_frames of beep."""
        snap = dict(
            osd=self.osd.copy(),
            blend=self.blend.astype(np.int32).copy(),
            progress=self.progress.astype(np.int32).copy(),
            parity=(self.frame_counter & 1).astype(np.int32),
            hscroll=self.hscroll.astype(np.int32).copy(),
            beep_left=self.beep_frames.astype(np.int32).copy(),
        )
        self.frame_counter += 2
        for _ in range(2):
            self.blend = np.where(self.blend > 0, self.blend - 1,
                                  self.blend)
            if (self.animate_index != 0).any() or \
                    (self.hscroll != 0).any():
                self._animate_step()
        self.beep_frames = np.maximum(
            self.beep_frames - n_aud_frames, 0)
        return snap

    def slide_planes(self):
        """(y, u, v) outgoing-frame snapshots (numpy) for the scroll
        blit, or None when no slide has ever started."""
        return self._slide

    # -- synthesis ------------------------------------------------------
    def _slide_on_device(self):
        """The slide snapshots on the device, uploading only what
        start_slide changed since the last call (or all of them once)."""
        if self._slide_dev is None:
            self._slide_dev = tuple(torch.from_numpy(s).to(self.device)
                                    for s in self._slide)
        elif self._slide_dirty:
            lanes = sorted(self._slide_dirty)
            idx = torch.tensor(lanes, device=self.device)
            for d, s in zip(self._slide_dev, self._slide):
                d[idx] = torch.from_numpy(s[lanes]).to(self.device)
        self._slide_dirty.clear()
        return self._slide_dev

    def _tensor(self, a, dtype):
        return torch.as_tensor(a).to(self.device, dtype)

    def synthesize(self, y, u, v):
        """One field per lane: uint8[N, line_count, line_width] on the
        stage's device (numpy or tensor planes, 352x192).  Equal to the
        JAX stage's C.synthesize_field / synthesize_field_scrolled at
        parity frame_counter & 1: ops/composite.synthesize_field, K4's
        field 0 at that parity laid into the field's template."""
        planes = tuple(self._tensor(p, torch.uint8) for p in (y, u, v))
        parity = self._tensor((self.frame_counter & 1).astype(np.int32),
                              torch.int32)
        if (self.hscroll != 0).any():
            # some lane is mid-slide: a per-lane wraparound of
            # (current, outgoing) buffers first
            planes = C.apply_hscroll(*planes, *self._slide_on_device(),
                                     self._tensor(self.hscroll,
                                                  torch.int32))
        fields = C.synthesize_field(
            *planes, parity, self._tensor(self.osd, torch.uint8),
            self._tensor(self.blend, torch.int32),
            self._tensor(self.progress, torch.int32), pal=self.pal)
        self._last = (y, u, v)
        self.frame_counter += 1
        # end-of-field updates: fade countdown + slide animator
        # (video.cpp:1190-1196)
        self.blend = np.where(self.blend > 0, self.blend - 1, self.blend)
        if (self.animate_index != 0).any() or (self.hscroll != 0).any():
            self._animate_step()
        return fields

    def modulate(self, pcm, starved=None):
        """PCM int16[N, T] -> PDM words uint16-in-int32[N, 2T] on the
        stage's device.  Lanes with a pending beep play the sine
        instead (espflix.ino write_pcm_16 beep branch).  starved:
        optional bool[N]; those lanes get the literal 0xAAAA PDM silence
        pattern with their modulator state untouched (video.cpp:997-1001
        writes the silence buffer without running the modulator)."""
        pcm = self._tensor(pcm, torch.int16)
        T = pcm.shape[1]
        beeping = self.beep_frames > 0
        if beeping.any():
            wave = torch.from_numpy(
                (_SIN32[np.arange(T) & 31] >> 2).astype(np.int16))
            pcm = torch.where(self._tensor(beeping, torch.bool)[:, None],
                              wave.to(self.device)[None], pcm)
            self.beep_frames = np.maximum(
                self.beep_frames - (T + 127) // 128, 0)
        state_in = self.pdm_state
        out, self.pdm_state = DS.modulate(pcm.contiguous(), state_in,
                                          n_samples=T)
        if starved is not None and _host(starved).any():
            sv = self._tensor(_host(starved).astype(bool), torch.bool)
            out = torch.where(sv[:, None], DS.SILENCE_WORD, out)
            self.pdm_state = torch.where(sv[:, None], state_in,
                                         self.pdm_state)
        return out


# the attributes stage_from_numpy carries: arrays, and the slide / last
# plane triples
_ARRAYS = ("osd", "blend", "progress", "frame_counter", "last_seconds",
           "beep_frames", "animate_index", "hscroll")


def stage_from_numpy(fields: dict, device) -> OutputStage:
    """A port OutputStage from a JAX stage's attributes as numpy arrays
    (``{name: np.asarray(getattr(jax_stage, name))}``): osd, blend,
    progress, frame_counter, last_seconds, pdm_state, beep_frames,
    animate_index, hscroll, and _slide / _last as (y, u, v) triples or
    None.  n and pal come from the arrays and ``fields["pal"]``."""
    osd = np.asarray(fields["osd"])
    st = OutputStage(osd.shape[0], pal=bool(fields.get("pal", False)),
                     device=device)
    for k in _ARRAYS:
        a = np.asarray(fields[k])
        setattr(st, k, a.astype(getattr(st, k).dtype, copy=True))
    st.pdm_state = torch.from_numpy(
        np.array(fields["pdm_state"], np.int32)).to(st.device)
    for k in ("_slide", "_last"):
        v = fields.get(k)
        setattr(st, k, None if v is None else tuple(
            np.array(p, np.uint8) for p in v))
    return st
