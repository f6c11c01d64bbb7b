"""Output stage host state: per-lane OSD, flip animation, beep, PDM state.

The port of espflix_tpu.runtime.output.OutputStage (output.py:32-143):
the per-lane OSD state (time readout, progress bar, fade countdown), the
buffer-flip slide animator and the key-feedback beep, kept on the host
exactly as the reference ISR keeps them (video.cpp:1077-1198,
espflix.cpp:862-884), and ``tick_state``, the per-tick snapshot the
device chain (runtime/chain.py) consumes.  The modulator state
``pdm_state`` is an int32[N, 3] tensor on the fleet's device.

The per-field path outside the chain (OutputStage.synthesize /
modulate, output.py:146-198) is not ported yet; see ROADMAP.md.
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
        self.pdm_state = DS.init_state(n_lanes, device)
        self.beep_frames = np.zeros(n_lanes, np.int32)
        # buffer-flip slide animation (video.cpp:936-943, 1077-1088):
        # per-lane ease counter, current hscroll, and the "other
        # buffer" snapshot the new frame slides against
        self.animate_index = np.zeros(n_lanes, np.int32)
        self.hscroll = np.zeros(n_lanes, np.int32)
        self._slide = None               # (y, u, v) snapshots

    # -- flip animation (video.cpp:1077-1088, 1163-1178) ----------------
    def start_slide(self, lane: int, direction: int, prev=None):
        """Begin the ease-in/out horizontal slide on a buffer flip.

        direction: the reference's flush_picture mode -- 2 slides the
        new frame in from the left (load_poster dir < 0), 3 from the
        right (espflix.cpp:1060-1069).  prev: (y, u, v) planes of the
        outgoing frame (numpy or tensors).  The JAX stage defaults prev
        to the last planes its per-field synthesize() produced; the
        port's stage synthesizes nothing outside the chain, so without
        prev there is nothing to slide from and the call does nothing.
        """
        if prev is None:
            return
        prev = tuple(_host(p) for p in prev)
        if self._slide is None:
            self._slide = tuple(np.zeros_like(p) for p in prev)
        for buf, p in zip(self._slide, prev):
            buf[lane] = p[lane]
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
