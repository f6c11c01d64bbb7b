"""The traced run's instruments: a profiler over a steady stretch of the
window, and CUDA-event spans per chain stage.

``Profile`` runs `torch.profiler` (CPU and CUDA activities) from
`start()` to `stop()`, exports its Chrome trace into the run's TMPDIR,
reads it back and deletes it.  What it keeps: the stretch (the host
interval from start to stop), every device interval (kernels, memory
copies and sets) with its name, and the benchmark's own host spans
(`record_function` ranges named ``espbench.*`` and the fleet's timers).
The arithmetic on them is in stats.py.

``StageTimer`` is the chain's `timer=` argument (chain.FullChain.tick):
CUDA events around each stage, summed per stage.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Profile:
    """One profiled stretch of a window (see the module's docstring)."""

    def __init__(self):
        self.prof = None
        self.done = False
        self.ticks = 0
        self.stretch = None      # (start, end) host seconds, trace clock
        self.device = []         # [(start, end, name, cat)] seconds
        self.spans = []          # [(start, end, name)] host seconds

    def start(self):
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self._range = torch.profiler.record_function("espbench.stretch")
        self._range.__enter__()

    def stop(self):
        torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.done = True
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        self._read(events)

    def _read(self, events):
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            s = float(e["ts"]) * 1e-6
            iv = (s, s + float(e["dur"]) * 1e-6)
            cat, name = e.get("cat", ""), e.get("name", "")
            if cat in DEVICE_CATS:
                self.device.append(iv + (name, cat))
            elif cat == "user_annotation":
                if name == "espbench.stretch":
                    self.stretch = iv
                elif name.startswith("espbench.") or \
                        name.startswith("fleet."):
                    self.spans.append(iv + (name,))


class StageTimer:
    """CUDA-event spans per chain stage, summed per stage."""

    def __init__(self):
        self.spans = []

    @contextlib.contextmanager
    def __call__(self, name):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        yield
        b.record()
        self.spans.append((name, a, b))

    def totals_s(self) -> dict:
        torch.cuda.synchronize()
        out = {}
        for name, a, b in self.spans:
            out[name] = out.get(name, 0.0) + a.elapsed_time(b) * 1e-3
        return out
