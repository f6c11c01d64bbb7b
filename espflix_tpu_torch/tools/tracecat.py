"""Trace viewer: render EventLog rings, timer reports and profiler
dumps as human-readable timelines (the `trace_flush`/`task_dump`
console views of prof.cpp:31-78, plus a JSON export for external
viewers).

Copied from espflix_tpu/tools/tracecat.py; tests/test_torch_isolation.py
pins the copy to the original.

Library use:
    from espflix_tpu_torch.tools.tracecat import format_events, to_chrome
CLI use (reads a JSON dump produced by `dump_json`):
    python -m espflix_tpu_torch.tools.tracecat trace.json
"""

from __future__ import annotations

import json
import sys

from espflix_tpu_torch.runtime.events import Ev, EventLog, Timers


def format_events(log: EventLog, last: int = 64) -> str:
    """Aligned timeline of the most recent events, relative times."""
    evs = log.dump(last)
    if not evs:
        return "(no events)"
    t0 = evs[0].t
    lines = [f"{'t(ms)':>9}  {'event':<16} {'lane':>5}  value"]
    for e in evs:
        lines.append(f"{(e.t - t0) * 1e3:9.2f}  {e.ev.name:<16} "
                     f"{e.lane:>5}  {e.value}")
    return "\n".join(lines)


def format_counts(log: EventLog) -> str:
    c = log.counts()
    if not c:
        return "(no events)"
    width = max(len(k) for k in c)
    return "\n".join(f"{k:<{width}}  {v}" for k, v in
                     sorted(c.items(), key=lambda kv: -kv[1]))


def format_timers(timers: Timers) -> str:
    """MEASURE/REPORT-style percent breakdown (player.cpp:333-346)."""
    rep = timers.report()
    if not rep:
        return "(no timers)"
    width = max(len(k) for k in rep)
    lines = [f"{'stage':<{width}}  {'calls':>6} {'total(s)':>9} {'%':>5}"]
    for k, v in rep.items():     # report() is sorted by total
        lines.append(f"{k:<{width}}  {v['calls']:>6} "
                     f"{v['total_s']:>9.3f} {v['pct']:>5.1f}")
    return "\n".join(lines)


def dump_json(path: str, log: EventLog | None = None,
              timers: Timers | None = None, samples=None):
    """Persist a trace for the CLI / external tools."""
    doc = {}
    if log is not None:
        doc["events"] = [dict(t=e.t, ev=e.ev.name, lane=e.lane,
                              value=e.value) for e in log.dump(10 ** 9)]
    if timers is not None:
        doc["timers"] = timers.report()
    if samples is not None:
        doc["samples"] = samples
    with open(path, "w") as f:
        json.dump(doc, f)


def to_chrome(events: list[dict]) -> list[dict]:
    """Chrome trace-event format (chrome://tracing / Perfetto): one
    instant event per log entry, lane as the thread id."""
    return [dict(name=e["ev"], ph="i", s="t",
                 ts=int(e["t"] * 1e6), pid=0,
                 tid=e.get("lane", -1) + 1)
            for e in events]


def main(argv=None):
    argv = argv or sys.argv[1:]
    if not argv:
        print(__doc__)
        return 1
    with open(argv[0]) as f:
        doc = json.load(f)
    if "--chrome" in argv:
        json.dump(to_chrome(doc.get("events", [])), sys.stdout)
        return 0
    evs = doc.get("events", [])
    if evs:
        t0 = evs[0]["t"]
        print(f"{'t(ms)':>9}  {'event':<16} {'lane':>5}  value")
        for e in evs:
            print(f"{(e['t'] - t0) * 1e3:9.2f}  {e['ev']:<16} "
                  f"{e['lane']:>5}  {e['value']}")
    for k, v in doc.get("timers", {}).items():
        print(f"timer {k}: calls={v['calls']} total={v['total_s']:.3f}s "
              f"({v['pct']:.1f}%)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
