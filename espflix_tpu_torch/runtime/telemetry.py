"""The port's own spans, counters and chunk records.

Tracing is on exactly while a `torch.profiler` records (``tracing()``,
torch.autograd._profiler_enabled(), ~0.2 us); there is no flag of its
own.  While it is off nothing here opens a profiler range, records a
CUDA event or synchronises: only the counters count.

- ``Timers``: runtime/events.Timers whose ``measure(name)`` also opens
  the profiler range ``fleet.<name>`` while tracing.  Fleet.timers is
  one; its spans and the sub-spans nested in them (``NESTED``) are
  listed in runtime/scheduler.py's docstring.
- counters: Fleet.counters, a dict of named running totals, holds the
  session feed's: ``feed.bytes_read`` (bytes the pump rounds fed),
  ``feed.mapped_bytes`` (those of them the packed gather took from
  read-only mappings of the title files, streaming/title_maps.py, and
  not from the streamers), ``feed.rounds`` (pump rounds),
  ``feed.lane_ticks`` (lanes playing, fast-forwarding or rewinding at
  a tick's start) and
  ``feed.underruns`` (those of them that ended the tick with no
  picture), added once a tick (runtime/host_gather.add_counts); the
  packed gather adds ``feed.trick_lane_ticks`` (lanes fast-forwarding
  or rewinding at a tick's start), ``feed.slow_lane_ticks`` (playing
  lanes off the native fast path, as a lane whose session fell back to
  the Python feed is) and ``feed.attaches`` (lanes the tick's check
  attached to a title mapping).  ``Fleet.apply_keys``, the remote's
  keys between chunks, spans ``control`` and counts ``control.keys``
  (keys applied), ``control.seeks`` (those after which the lane's
  stream reopened) and ``control.seek_wait`` (lane-ticks from a seek up
  to and including the lane's first presented picture, counted where
  run_chunk_full presents a chunk's results).  A pooled chunk
  (Fleet.run_chunk_full_pooled) adds its workers' ``feed.*`` counts and
  the pool's: ``pool.worker_us`` (the slowest worker's own gather a
  tick, in microseconds), ``pool.worker_us_sum`` (every worker's),
  ``pool.reply_bytes`` (the pickled replies received) and
  ``pool.ticks``.  ``delta`` is a stretch's share of them.
- ``ChainSpans``: the chain's spans per stage for one FullChain call
  while tracing (runtime/chain.py): a mark before the first tick and at
  the end of each stage (CUDA events on a card, the host clock on the
  CPU, where the work is synchronous), and the ranges
  ``fleet.chain.<stage>``.  A stage's time runs from the mark before it
  to its own, so the glue between ticks counts to the next tick's scan
  and the stacking of the chunk's outputs to ``outs``.  A caller's own
  stage timer takes their place, and the mesh path, which calls
  FullChain.tick per shard, records none.
- ``RECORDS``: a bounded process-wide ring of chunk records, appended
  only while tracing: ``{"kind": "fleet" | "chain", "ticks": K,
  "counters": {...} | None, "device": {...} | None}``.  A "fleet"
  record holds a full-chain chunk's counter deltas (from a traced
  ``apply_keys`` call just before the chunk, when there was one), a
  "chain" record
  the chain's seconds per stage (STAGES, "outs") and its first-to-last
  span ("span"), resolved when read.  ``traced(kind, ticks)`` returns
  the newest records of a kind whose ticks sum to `ticks`, which is how
  a reader picks out a profiled stretch that starts and stops on chunk
  boundaries.

An operator runs the fleet under `torch.profiler` and reads the
``fleet.*`` ranges in its trace, ``Fleet.counters`` and ``traced``.
"""

from __future__ import annotations

import time
from collections import deque
from contextlib import contextmanager

import torch

from espflix_tpu_torch.runtime import events

STAGES = ("scan", "idct+compose", "composite", "sbc", "pdm")
# Fleet.timers' spans that lie inside another of its spans: gather.*
# inside gather_packed (or gather), pool_gather.* inside pool_gather,
# upload inside batch_assemble, readback inside host_sync
NESTED = ("gather.pop", "gather.read", "gather.feed", "pool_gather.wait",
          "pool_gather.join", "upload", "readback")
RECORDS: deque = deque(maxlen=256)


def tracing() -> bool:
    """Whether a torch.profiler records now."""
    return torch.autograd._profiler_enabled()


def top_level(acc: dict) -> dict:
    """A Timers' accumulators without the nested spans, whose sum is the
    timed share of the wall."""
    return {k: v for k, v in acc.items() if k not in NESTED}


def sync(*devices):
    """Wait for the devices' work (nothing to wait for on the CPU)."""
    for d in {torch.device(d) for d in devices}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class Timers(events.Timers):
    """events.Timers whose spans are also profiler ranges `fleet.<name>`
    while tracing."""

    @contextmanager
    def measure(self, name: str):
        if tracing():
            with torch.profiler.record_function("fleet." + name), \
                    super().measure(name):
                yield
        else:
            with super().measure(name):
                yield


def delta(counters: dict, before: dict) -> dict:
    """What a tally of running totals gained since `before`, a copy."""
    return {k: v - before.get(k, 0) for k, v in counters.items()}


def record(kind: str, ticks: int, counters: dict | None = None,
           device=None):
    """Append a chunk record; `device` may be a callable that resolves
    it when it is read."""
    RECORDS.append({"kind": kind, "ticks": ticks, "counters": counters,
                    "device": device})


def traced(kind: str, ticks) -> list | None:
    """The newest records of `kind` whose ticks sum to exactly `ticks`,
    oldest first, or None."""
    if not ticks:
        return None
    got, n = [], 0
    for r in reversed(RECORDS):
        if r["kind"] == kind:
            got.append(r)
            n += r["ticks"]
            if n >= ticks:
                break
    if n != ticks:
        return None
    for r in got:
        if callable(r["device"]):
            r["device"] = r["device"]()
    return got[::-1]


class ChainSpans:
    """One chain call's spans per stage (see the module's docstring)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.marks = []          # [(stage ending here or None, mark)]
        self._mark(None)

    def _mark(self, name):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record(torch.cuda.current_stream(self.device))
        else:
            e = time.perf_counter()
        self.marks.append((name, e))

    def _seconds(self, a, b) -> float:
        return a.elapsed_time(b) * 1e-3 if self.cuda else b - a

    @contextmanager
    def stage(self, name: str):
        """FullChain.tick's stage context: the range, then the mark."""
        with torch.profiler.record_function("fleet.chain." + name):
            yield
        self._mark(name)

    def close(self, ticks: int):
        """Mark the call's end and append its "chain" record."""
        self._mark("outs")
        record("chain", ticks, device=self.resolve)

    def resolve(self) -> dict:
        """Seconds per stage (summed over the ticks), "outs" and the
        first-to-last "span"."""
        if self.cuda:
            self.marks[-1][1].synchronize()
        out = dict.fromkeys(STAGES + ("outs",), 0.0)
        for (_n, a), (name, b) in zip(self.marks, self.marks[1:]):
            out[name] += self._seconds(a, b)
        out["span"] = self._seconds(self.marks[0][1], self.marks[-1][1])
        return out
