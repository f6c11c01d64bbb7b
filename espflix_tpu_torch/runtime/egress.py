"""Host-side signal egress: drain tapped lanes' DAC fields + PDM at
line rate.

Copied from espflix_tpu/runtime/egress.py; tests/test_torch_isolation.py
pins the copy to the original.

The reference outputs every DAC sample for real -- the I2S DMA ring
empties at 14.318 MSa/s (NTSC) whether or not anyone is watching
(src/video.cpp:218-225), and the audio path pushes
1.536 Mb/s of PDM bits (espflix.ino:123-145).  In the TPU fleet the
chain reduces every lane's signal to per-lane checksums and returns
FULL fields/PDM only for a small set of tapped lanes
(runtime/chain.py); this module is the measured consumer story for
those taps: a bounded ring buffer between the tick producer (the
Fleet) and a paced consumer thread that "transmits" one display
frame's bytes per tick interval -- the stand-in for a DMA to the
egress NIC.

Semantics mirror the reference's DMA clock:

  * the consumer runs on ITS OWN clock (one frame pair + one tick of
    PDM words per tick interval, 1/29.97 s NTSC / 1/25 s PAL) -- like
    the ISR, it never waits for the producer;
  * a consumer tick with no queued frame is an UNDERRUN (the
    reference's "late video" report, video.cpp:1045-1052): accounted,
    and the consumer idles that interval;
  * a producer push onto a full ring DROPS the oldest entry (bounded
    memory like the 2-line DMA ring; drop accounting replaces the
    reference's silent overwrite).

`python -m espflix_tpu_torch.tools.serve_scenario --stage full --egress K`
wires K tapped lanes through one EgressPump and reports the delivery
stats in its JSON summary.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class EgressStats:
    pushed_ticks: int = 0          # producer pushes (per-tick, all lanes)
    consumed_ticks: int = 0        # consumer intervals with data
    underrun_ticks: int = 0        # consumer intervals with empty ring
    dropped_ticks: int = 0         # ring-full evictions
    delivered_field_bytes: int = 0
    delivered_pdm_words: int = 0
    checksum: int = 0              # running int32 sum of delivered bytes
    wall_seconds: float = 0.0

    def line_rate_bytes_per_s(self) -> float:
        if self.wall_seconds <= 0:
            return 0.0
        return (self.delivered_field_bytes
                + 4 * self.delivered_pdm_words) / self.wall_seconds


class EgressRing:
    """Bounded per-tick ring between the fleet and the consumer.

    Entries are (fields u8[tap, 2, L, W], pdm i32[tap, S]) numpy
    arrays -- one tick's signal for every tapped lane.  push() never
    blocks: a full ring evicts the oldest entry (accounted as a
    dropped tick)."""

    def __init__(self, depth: int = 8):
        self.depth = depth
        self._q: list = []
        self._lock = threading.Lock()
        self.dropped = 0

    def push(self, fields: np.ndarray, pdm: np.ndarray) -> None:
        with self._lock:
            if len(self._q) >= self.depth:
                self._q.pop(0)
                self.dropped += 1
            self._q.append((fields, pdm))

    def pop(self):
        with self._lock:
            if not self._q:
                return None
            return self._q.pop(0)

    def __len__(self):
        with self._lock:
            return len(self._q)


class EgressPump:
    """Paced consumer thread: one ring entry per tick interval.

    sink: callable(bytes_view) -> None, default counts + checksums
    (the stand-in for the NIC DMA write).  Call start() after
    creating, push() per tick from the fleet loop, and finish() to
    drain the tail and join."""

    def __init__(self, tick_interval: float, depth: int = 8,
                 sink=None):
        self.ring = EgressRing(depth)
        self.interval = float(tick_interval)
        self.stats = EgressStats()
        self._sink = sink
        self._stop = threading.Event()
        self._drain = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._t0 = None

    # -- producer side ---------------------------------------------------
    def start(self) -> None:
        self._t0 = time.monotonic()
        self._thread.start()

    def push(self, tap_fields, tap_pdm) -> None:
        """One tick's taps (device or numpy arrays; [T?, tap, ...]
        stacks from a chunked TickResult arrive per tick already)."""
        f = np.asarray(tap_fields)
        p = np.asarray(tap_pdm)
        self.ring.push(f, p)
        self.stats.pushed_ticks += 1

    def finish(self, timeout: float = 10.0) -> EgressStats:
        """Let the consumer drain whatever is queued, then stop."""
        self._drain.set()
        deadline = time.monotonic() + timeout
        while len(self.ring) and time.monotonic() < deadline:
            time.sleep(self.interval / 4)
        self._stop.set()
        self._thread.join(timeout=timeout)
        self.stats.dropped_ticks = self.ring.dropped
        self.stats.wall_seconds = time.monotonic() - self._t0
        return self.stats

    # -- consumer side ---------------------------------------------------
    def _transmit(self, fields: np.ndarray, pdm: np.ndarray) -> None:
        if self._sink is not None:
            self._sink(fields, pdm)
        else:
            # checksum = the delivery witness (a real deployment DMAs
            # these bytes to the egress NIC at DAC rate)
            self.stats.checksum = (
                self.stats.checksum
                + int(fields.astype(np.int64).sum())
                + int(pdm.astype(np.int64).sum())) & 0x7FFFFFFF
        self.stats.delivered_field_bytes += fields.size
        self.stats.delivered_pdm_words += pdm.size
        self.stats.consumed_ticks += 1

    def _run(self) -> None:
        next_due = time.monotonic()
        while not self._stop.is_set():
            now = time.monotonic()
            if now < next_due:
                time.sleep(min(next_due - now, 0.005))
                continue
            entry = self.ring.pop()
            if entry is not None:
                self._transmit(*entry)
            elif self._drain.is_set():
                # tail drained; park until stopped
                time.sleep(self.interval / 4)
                continue
            else:
                self.stats.underrun_ticks += 1
            next_due += self.interval
            # a long stall (producer paused for a chunk) must not turn
            # into a burst of back-to-back "ticks": re-anchor the clock
            if next_due < time.monotonic() - 8 * self.interval:
                next_due = time.monotonic()
