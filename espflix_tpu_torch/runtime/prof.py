"""Sampling + task profilers (the prof.cpp equivalents).

Copied from espflix_tpu/runtime/prof.py; tests/test_torch_isolation.py
pins the copy to the original.

The reference profiles with ISR hooks: a 15.7kHz PC-sampling histogram
over the decoder (video.cpp:1094-1108, dumped by prof.cpp:31-39), a
per-core task sampler (prof.cpp:44-60, %-per-core dump :62-78), the
PLOG event ring (prof.cpp:80-103 -- covered by runtime/events.EventLog)
and AddTicks/MEASURE-REPORT tick meters (streamer.h:131-137,
player.cpp:333-346 -- covered by runtime/events.Timers).

Host-side, the analogue of "sample the PC from the ISR" is a sampler
thread walking sys._current_frames() on a fixed period: SamplingProfiler
histograms where a chosen thread spends time (function granularity --
the statistical decoder-hotspot view); TaskProfiler counts which threads
are on-CPU-ish (runnable frames) for the %-per-task dump.  Device-side
profiling goes through jax.profiler traces (see docs/PERF.md); these
cover the host pipeline that feeds it.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import Counter


class SamplingProfiler:
    """Statistical profile of one thread (default: the caller's)."""

    def __init__(self, thread_id: int | None = None,
                 interval: float = 0.001):
        self._tid = thread_id or threading.get_ident()
        self._interval = interval
        self._hist: Counter[str] = Counter()
        self._samples = 0
        self._stop = threading.Event()
        self._thread = None

    def _run(self):
        while not self._stop.is_set():
            frame = sys._current_frames().get(self._tid)
            if frame is not None:
                code = frame.f_code
                key = f"{code.co_name} ({code.co_filename.rsplit('/', 1)[-1]}:{frame.f_lineno})"
                self._hist[key] += 1
                self._samples += 1
            time.sleep(self._interval)

    def start(self):
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def flush(self, top: int = 20) -> list[tuple[str, float]]:
        """(site, fraction) hottest-first (trace_flush, prof.cpp:31-39)."""
        total = max(self._samples, 1)
        out = [(k, v / total) for k, v in self._hist.most_common(top)]
        self._hist.clear()
        self._samples = 0
        return out


class TaskProfiler:
    """Which threads are busy: sampled thread census with % dump
    (task_dump, prof.cpp:62-78)."""

    def __init__(self, interval: float = 0.001):
        self._interval = interval
        self._counts: Counter[str] = Counter()
        self._samples = 0
        self._stop = threading.Event()
        self._thread = None

    def _run(self):
        names = {}
        while not self._stop.is_set():
            for t in threading.enumerate():
                names[t.ident] = t.name
            for tid in sys._current_frames():
                self._counts[names.get(tid, str(tid))] += 1
            self._samples += 1
            time.sleep(self._interval)

    def start(self):
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def dump(self) -> dict[str, float]:
        total = max(self._samples, 1)
        return {k: v / total for k, v in self._counts.most_common()}
