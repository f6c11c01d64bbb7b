"""Presentation clock: PTS -> frame-counter scheduling.

Copied from espflix_tpu/video/clock.py; tests/test_torch_isolation.py
pins the copy to the original.

Model of the reference's A/V master clock (src/
video.cpp:1024-1057): the display's field counter (60/s NTSC, 50/s PAL)
is the timebase; a 90 kHz PTS maps to counter units by /1500 (NTSC) or
/1800 (PAL); the first presented frame latches an origin pair; frames
later than 2 counts re-latch the origin (the "resetting v timing"
recovery); pause freezes the mapping.
"""

from __future__ import annotations

from dataclasses import dataclass

NTSC_DIV = 1500
PAL_DIV = 1800


@dataclass
class PresentationClock:
    pal: bool = False
    frame_counter: int = 0       # advanced by the output stage
    pts_origin: int = 0
    counter_origin: int | None = None   # None = unlatched
    paused_at: int = 0
    late_resets: int = 0

    @property
    def div(self) -> int:
        return PAL_DIV if self.pal else NTSC_DIV

    def tick(self, n: int = 1):
        self.frame_counter += n

    def due_time(self, pts: int) -> int:
        """Counter value at which a frame with this PTS should display;
        latches the origin on first use."""
        vpts = pts // self.div
        if self.counter_origin is None:
            self.pts_origin = vpts
            self.counter_origin = self.frame_counter
        due = (vpts - self.pts_origin) + self.counter_origin
        if due < self.frame_counter:
            late = self.frame_counter - due
            if late > 2:
                self.counter_origin = None  # re-latch on next frame
                self.late_resets += 1
        return due

    def pause(self, p: bool):
        if p:
            self.paused_at = self.frame_counter
        else:
            self.counter_origin = None
            self.paused_at = 0

    def reset(self):
        self.pts_origin = 0
        self.counter_origin = None
        self.paused_at = 0
