"""Structured pipeline event log + timing meters (observability).

Copied from espflix_tpu/runtime/events.py; tests/test_torch_isolation.py
pins the copy to the original.

Replaces the reference's PLOG ring of packed (ccount|event|core) words
(src/prof.cpp:80-103, streamer.h:11-32) and its
AddTicks/MEASURE percent breakdowns (player.cpp:333-346) with a typed
ring buffer and named timers.
"""

from __future__ import annotations

import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass
from enum import IntEnum


class Ev(IntEnum):
    # mirrors streamer.h:11-22
    PDM_START = 1
    PDM_END = 2
    VIDEO_PES = 3
    AUDIO_PES = 4
    PUSH_AUDIO = 5
    PUSH_VIDEO = 6
    VIDEO_READY = 7
    WAIT_BUFFER = 8
    REQUEST_BUFFER = 9
    RECEIVED_BUFFER = 10
    # framework-specific
    DECODE_BATCH = 16
    SCAN_DONE = 17
    SYNTH_BATCH = 18
    FETCH = 19
    SEEK = 20
    LANE_ERROR = 21
    LANE_RESYNC = 22
    LANE_GEOMETRY = 23      # picture geometry != fleet geometry
    LANE_OVERSIZE = 24      # picture payload exceeds words_per_lane
    AUDIO_STARVED = 25      # playing lane underran its SBC ring
    AUDIO_ERROR = 26        # SBC decode anomaly (video.cpp:1013-1014)
    AUDIO_OP_POINT = 27     # lane's SBC channel/block config differs
    # from the fleet chain's group: its audio is silent in the fused
    # chain until it lands on a matching fleet (value = channels<<8 |
    # blocks).  Frame-SIZE diversity is handled (headers are
    # self-describing); only channel-count/blocks diversity parks.


@dataclass
class Event:
    t: float
    ev: Ev
    lane: int
    value: int


class EventLog:
    """Bounded ring of pipeline events; cheap enough for per-tick use."""

    def __init__(self, capacity: int = 4096, enabled: bool = True):
        self.ring: deque[Event] = deque(maxlen=capacity)
        self.enabled = enabled

    def log(self, ev: Ev, lane: int = -1, value: int = 0):
        if self.enabled:
            self.ring.append(Event(time.monotonic(), ev, lane, value))

    def dump(self, last: int = 64) -> list[Event]:
        return list(self.ring)[-last:]

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for e in self.ring:
            out[e.ev.name] = out.get(e.ev.name, 0) + 1
        return out


class Timers:
    """Named wall-clock accumulators with percent breakdown
    (the MEASURE/REPORT analogue)."""

    def __init__(self, enabled: bool = True):
        self.acc: dict[str, float] = {}
        self.n: dict[str, int] = {}
        self.enabled = enabled

    @contextmanager
    def measure(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.monotonic()
        try:
            yield
        finally:
            dt = time.monotonic() - t0
            self.acc[name] = self.acc.get(name, 0.0) + dt
            self.n[name] = self.n.get(name, 0) + 1

    def report(self) -> dict[str, dict]:
        total = sum(self.acc.values()) or 1.0
        return {
            k: dict(total_s=round(v, 4), calls=self.n[k],
                    pct=round(100 * v / total, 1))
            for k, v in sorted(self.acc.items(), key=lambda kv: -kv[1])
        }

