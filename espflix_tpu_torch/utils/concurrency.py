"""Concurrency kit: queues, event-group bits, threads, tick sources.

Copied from espflix_tpu/utils/concurrency.py; tests/test_torch_isolation.py
pins the copy to the original.

Equivalent of the reference's FreeRTOS/POSIX portability kit
(streamer.h:76-127, streamer.cpp:166-248 ESP / 302-389 POSIX): `Q`
(bounded pointer queue, depth 32), a global event group of bit flags
with wait-any/wait-all, `start_thread` (pinned task / std::thread) and
cycle/microsecond tick sources.  The host pipeline (fetch pool, fleet
scheduler, audio pump) coordinates through these exactly as the
reference's three cores did.
"""

from __future__ import annotations

import queue
import threading
import time


class Q:
    """Bounded FIFO of items (reference depth 32, streamer.cpp:168).

    push blocks when full (backpressure -- the reference's pop_empty
    block, player.cpp:376-379); pop blocks when empty; pop_nowait
    returns None instead."""

    def __init__(self, depth: int = 32):
        self._q = queue.Queue(maxsize=depth)

    def push(self, item, timeout: float | None = None) -> bool:
        try:
            self._q.put(item, timeout=timeout)
            return True
        except queue.Full:
            return False

    def pop(self, timeout: float | None = None):
        return self._q.get(timeout=timeout)

    def pop_nowait(self):
        try:
            return self._q.get_nowait()
        except queue.Empty:
            return None

    def __len__(self):
        return self._q.qsize()


class EventGroup:
    """Bit flags with blocking waits (xEventGroupWaitBits semantics:
    wait for ANY or ALL of a mask, optionally clearing on exit)."""

    def __init__(self):
        self._bits = 0
        self._cond = threading.Condition()

    def set_bits(self, mask: int) -> int:
        with self._cond:
            self._bits |= mask
            self._cond.notify_all()
            return self._bits

    def clear_bits(self, mask: int) -> int:
        with self._cond:
            self._bits &= ~mask
            return self._bits

    def get_bits(self) -> int:
        with self._cond:
            return self._bits

    def wait(self, mask: int, *, all_bits: bool = False,
             clear: bool = False, timeout: float | None = None) -> int:
        def ready():
            got = self._bits & mask
            return got == mask if all_bits else got != 0

        with self._cond:
            ok = self._cond.wait_for(ready, timeout=timeout)
            got = self._bits & mask
            if ok and clear:
                self._bits &= ~mask
            return got


def start_thread(fn, *args, name: str | None = None) -> threading.Thread:
    """Daemon worker (start_thread, streamer.cpp:233-248; core pinning
    has no host analogue)."""
    t = threading.Thread(target=fn, args=args, name=name, daemon=True)
    t.start()
    return t


def ticks() -> int:
    """Monotonic cycle-ish counter (ccount / rdtsc analogue)."""
    return time.perf_counter_ns()


def us() -> int:
    return time.perf_counter_ns() // 1000
