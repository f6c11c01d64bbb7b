"""The port's own spans, counters and chunk records
(runtime/telemetry.py) on the CPU, and the benchmark's readers of them.

A three-lane full-chain fleet over a file:// service, on the packed
gather (native feeds) and on the classic one (Python feeds, which pop
no native lane): with no profiler recording, the fleet
and its chain open no profiler range, record no CUDA event and append
no chunk record, and the feed counters still count -- the bytes the
sessions' streamers returned, a round or more a tick, and as many
playing lane-ticks less underruns as lanes presented pictures.  With
tracing on, each gather sub-span, `upload` and `readback` nest in their
parents, every chain stage of every tick has its range, and
`telemetry.traced` returns exactly the traced chunks; a caller's stage
timer takes the place of the chain's own spans.  (The gate is simulated
there and the ranges kept on the host clock: a CPU profiler's trace of
the plain forms holds ~400,000 operations a tick.  One chunk of one
tick runs under a real CPU torch.profiler, whose exported trace shows
the same.)  Under a real profiler too, a control call between chunks
(Fleet.apply_keys) opens `fleet.control` and the next chunk's record
carries its counts.  The pooled chain counts its workers' feeds.  The packed
gather takes file:// lanes' bytes from the title mappings
(`feed.mapped_bytes` == `feed.bytes_read`) and leaves lanes over a
`get_rom` buffer on their streamers (`feed.mapped_bytes` 0).  Each of the benchmark's
readers of these spans and records returns its value from a fabricated
stretch, and nothing when the stretch's records or spans are not
there.  On a card (gpu-marked) a chain record's stages sum to its
first-to-last span.
"""

import json
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from espflix_tpu_torch.runtime import telemetry as T
from espflix_tpu_torch.runtime.player import PlayerSession
from espflix_tpu_torch.runtime.scheduler import Fleet
from espflix_tpu_torch.streaming.streamer import Streamer
from espflix_tpu_torch.tools.indexer import make_service
from espflix_tpu_torch.tools.sbc_encode import random_frame

torch.set_num_threads(1)

LANES = 3
K = 2                    # ticks a chunk
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(scope="module")
def service(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("svc_telemetry"))
    rng = np.random.default_rng(9)
    audio = [(random_frame(rng, mode=0, bitpool=28), k * 240)
             for k in range(200)]
    make_service(d, ["one"], seed=9, n_gops=3, gop=4, audio_frames=audio)
    return "file://" + d


def _fleet(service, read: list | None, source: str = "file",
           native: bool = True):
    """A full-chain CPU fleet of LANES playing lanes (one SBC frame a
    tick keeps the plain PDM short) whose streamers add the bytes they
    return to read[0] (read None: the stock streamers); source "rom"
    plays the title from a get_rom buffer; native False gives the
    sessions Python feeds."""
    f = Fleet(LANES, words_per_lane=8192, parser="pallas", output=True,
              device="cpu", audio_frames_per_tick=1)
    for i in range(LANES):
        s = PlayerSession(service)
        assert s.init_service()
        with pytest.MonkeyPatch.context() as mp:
            if not native:
                mp.setenv("ESPFLIX_NATIVE_FEED", "0")
            s.nav(0)
            s.play_pause()
        if source == "rom":
            s.play_rom(Streamer().get_url(s.folder(0) + "/video.ts"))
        if read is None:
            f.attach(i, s)
            continue

        def counted(n, orig=s.streamer.read):
            out = orig(n)
            read[0] += len(out)
            return out
        s.streamer.read = counted
        f.attach(i, s)
    return f


def _ranges(prof, path) -> list:
    """(name, start, end) of the profiler's user ranges named fleet.*."""
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("cat") == "user_annotation"
            and e.get("ph") == "X" and e["name"].startswith("fleet.")]


class _Range:
    """A record_function stand-in that keeps (name, start, end)."""

    def __init__(self, log, name):
        self.log, self.name = log, name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.log.append((self.name, self.t0, time.perf_counter()))


@contextmanager
def simulated_tracing(ranges: list):
    """Tracing on without a profiler, whose CPU trace of the chain's
    plain forms runs to ~400,000 operations a tick: the gate reads True
    and each range opened is kept in `ranges` as (name, start, end)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(T, "tracing", lambda: True)
        mp.setattr(torch.profiler, "record_function",
                   lambda name: _Range(ranges, name))
        yield


@pytest.fixture(scope="module", params=["packed", "classic"])
def runs(request, service):
    """One untraced chunk (range openings and CUDA events counted), two
    traced ones, then one traced with a caller's stage timer."""
    read = [0]
    f = _fleet(service, read, native=request.param == "packed")
    opened = []
    n0 = len(T.RECORDS)
    with pytest.MonkeyPatch.context() as mp:
        for mod in (torch.profiler, torch.autograd.profiler):
            real = mod.record_function

            def rf(*a, real=real, **kw):
                opened.append(a)
                return real(*a, **kw)
            mp.setattr(mod, "record_function", rf)

        def event(*a, **kw):
            opened.append(("cuda event",))
            raise AssertionError("a CUDA event while untraced")
        mp.setattr(torch.cuda, "Event", event)
        untraced = f.run_chunk_full(K, tap_lanes=(0,))
    out = SimpleNamespace(fleet=f, packed=request.param == "packed",
                          read=read, opened=opened,
                          new_records=len(T.RECORDS) - n0,
                          untraced_counts=dict(f.counters), ranges=[])
    with simulated_tracing(out.ranges):
        traced = f.run_chunk_full(K) + f.run_chunk_full(K)
    out.fleet_recs = T.traced("fleet", 2 * K)
    out.chain_recs = T.traced("chain", 2 * K)
    out.fleet_short = T.traced("fleet", 2 * K - 1)
    out.traced_counts = dict(f.counters)
    # a caller's stage timer: the chain's own spans give way
    seen = []

    def timer(name):
        seen.append(name)
        return nullcontext()
    chain = f.chain
    n1 = len(T.RECORDS)
    f.chain = lambda *a, **kw: chain(*a, timer=timer, **kw)
    with simulated_tracing([]):
        timed = f.run_chunk_full(K)
    f.chain = chain
    out.caller_stages = seen
    out.caller_records = [r["kind"] for r in list(T.RECORDS)[n1:]]
    out.results = untraced + traced + timed
    return out


@pytest.fixture(scope="module")
def profiled(service, tmp_path_factory):
    """One chunk of one tick on the packed gather under a CPU
    torch.profiler: its exported fleet.* ranges and its records."""
    f = _fleet(service, [0])
    f.run_chunk_full(1)
    with torch.profiler.profile(activities=CPU) as prof:
        f.run_chunk_full(1)
    return SimpleNamespace(
        ranges=_ranges(prof, tmp_path_factory.mktemp("trace") / "t.json"),
        fleet=T.traced("fleet", 1), chain=T.traced("chain", 1))


def test_untraced_fleet_opens_no_range_and_records_nothing(runs):
    assert runs.opened == []
    assert runs.new_records == 0
    c = runs.untraced_counts
    assert c["feed.rounds"] >= K and c["feed.bytes_read"] > 0
    assert c["feed.lane_ticks"] == K * LANES
    # the classic gather of Python feeds pops no native lane
    pops = {"gather.pop", "gather.read"}
    assert set(runs.fleet.timers.acc) >= {
        "upload", "chain_enqueue", "readback", "host_sync",
        "batch_assemble"} | (pops if runs.packed else {"gather"})
    assert runs.packed or not pops & set(runs.fleet.timers.acc)


def test_feed_counters_match_the_sessions(runs):
    c = runs.fleet.counters
    ticks = len(runs.results)
    assert c["feed.bytes_read"] == runs.read[0]
    presented = sum(int(r.video_lanes.sum()) for r in runs.results)
    assert c["feed.lane_ticks"] - c["feed.underruns"] == presented
    assert c["feed.lane_ticks"] == ticks * LANES
    assert c["feed.rounds"] >= ticks


NESTS = [("fleet.gather.pop", "fleet.gather_packed"),
         ("fleet.gather.read", "fleet.gather_packed"),
         ("fleet.gather.feed", "fleet.gather_packed"),
         ("fleet.upload", "fleet.batch_assemble"),
         ("fleet.readback", "fleet.host_sync")]


def _nested(ranges, child, parent) -> bool:
    kids = [r for r in ranges if r[0] == child]
    outer = [r for r in ranges if r[0] == parent]
    return bool(kids and outer) and all(
        any(ps <= s and e <= pe for _p, ps, pe in outer)
        for _n, s, e in kids)


@pytest.mark.parametrize("child,parent", NESTS)
def test_traced_spans_nest_in_their_parents(runs, child, parent):
    if not runs.packed and parent == "fleet.gather_packed":
        # the classic gather of Python feeds: no native pop, so none of
        # the gather's sub-spans opens, and `gather` does
        assert [r for r in runs.ranges if r[0] == "fleet.gather"]
        assert not [r for r in runs.ranges if r[0] == child]
        return
    assert _nested(runs.ranges, child, parent)


def test_traced_chain_spans_every_stage_of_every_tick(runs):
    names = [r[0] for r in runs.ranges]
    for st in T.STAGES:
        assert names.count("fleet.chain." + st) == 2 * K, st
    assert names.count("fleet.chain_enqueue") == 2


def test_traced_returns_exactly_the_traced_chunks(runs):
    fl, ch = runs.fleet_recs, runs.chain_recs
    assert [r["ticks"] for r in fl] == [K, K] == [r["ticks"] for r in ch]
    assert runs.fleet_short is None
    got = {k: sum(r["counters"][k] for r in fl)
           for k in runs.traced_counts}
    assert got == T.delta(runs.traced_counts, runs.untraced_counts)
    for r in ch:
        d = r["device"]
        assert set(d) == set(T.STAGES) | {"outs", "span"}
        assert all(v >= 0 for v in d.values()) and d["scan"] > 0
        parts = sum(d[s] for s in T.STAGES) + d["outs"]
        assert parts == pytest.approx(d["span"], rel=1e-9)


def test_a_callers_stage_timer_wins(runs):
    assert runs.caller_stages == list(T.STAGES) * K
    assert runs.caller_records == ["fleet"]


def test_a_profiled_chunk_exports_its_spans(profiled):
    """Under a real torch.profiler: the ranges nest in the exported
    trace, every stage of the tick is there, and traced() returns the
    chunk's records."""
    for child, parent in NESTS:
        assert _nested(profiled.ranges, child, parent), child
    names = [r[0] for r in profiled.ranges]
    for st in T.STAGES:
        assert names.count("fleet.chain." + st) == 1, st
    (fl,), (ch,) = profiled.fleet, profiled.chain
    assert fl["counters"]["feed.lane_ticks"] == LANES
    assert ch["device"]["span"] > 0


def test_a_profiled_control_call_spans_and_counts(service, tmp_path):
    """Fleet.apply_keys under a real torch.profiler: the range
    fleet.control opens, and the next chunk's "fleet" record carries the
    control's and the gather's new counters: the key, its seek, the
    lane's wait for its first fast-forward picture, its trick
    lane-tick and its attach to the forward stream's mapping."""
    from espflix_tpu_torch.runtime.input import KEY_RIGHT
    f = _fleet(service, None)
    f.run_chunk_full(1)
    with torch.profiler.profile(activities=CPU) as prof:
        f.apply_keys({1: KEY_RIGHT})
        rs = f.run_chunk_full(1)
    names = [r[0] for r in _ranges(prof, tmp_path / "t.json")]
    assert names.count("fleet.control") == 1
    (fl,) = T.traced("fleet", 1)
    c = fl["counters"]
    assert rs[0].video_lanes[1]
    assert (c["control.keys"], c["control.seeks"],
            c["control.seek_wait"]) == (1, 1, 1)
    assert c["feed.trick_lane_ticks"] == 1 and c["feed.attaches"] == 1
    assert c["feed.slow_lane_ticks"] == 0
    assert c["feed.lane_ticks"] == LANES


def test_pooled_chunk_counts_its_workers_feeds(service):
    from espflix_tpu_torch.runtime.hostpool import HostPool
    n = 2
    f = Fleet(n, words_per_lane=8192, parser="pallas", output=True,
              device="cpu", audio_frames_per_tick=1)
    with HostPool(n, 2, 8192, f.mb_w, f.mb_h) as pool:
        for i in range(n):
            assert pool.attach(i, service)
            pool.call(i, "nav", 0)
            pool.call(i, "play_pause")
        with simulated_tracing([]):
            rs = f.run_chunk_full_pooled(pool, K)
    (rec,) = T.traced("fleet", K)
    assert rec["counters"] == f.counters
    c = f.counters
    assert c["feed.lane_ticks"] - c["feed.underruns"] == \
        sum(int(r.video_lanes.sum()) for r in rs)
    assert c["feed.bytes_read"] > 0 and c["feed.rounds"] >= K
    assert f.timers.n["upload"] == 1 and f.timers.n["readback"] == 1


@pytest.mark.parametrize("source", ["file", "rom"])
def test_mapped_bytes_count_the_mapped_reads(service, source):
    """file:// lanes read every byte from the title mappings; lanes over
    a get_rom buffer stay on their streamers and map nothing."""
    f = _fleet(service, None, source)
    for _ in range(3):
        assert f._gather_batch_packed() is not None
    c = f.counters
    assert c["feed.bytes_read"] > 0 and c["feed.lane_ticks"] == 3 * LANES
    if source == "file":
        assert c["feed.mapped_bytes"] == c["feed.bytes_read"]
        assert (f._titles.src >= 0).all()
    else:
        assert c["feed.mapped_bytes"] == 0
        assert (f._titles.src < 0).all()


def test_top_level_leaves_out_the_nested_spans():
    acc = {"gather_packed": 3.0, "gather.pop": 1.0, "gather.read": 1.0,
           "gather.feed": 0.5, "batch_assemble": 2.0, "upload": 1.0,
           "chain_enqueue": 1.0, "host_sync": 1.0, "readback": 0.5}
    assert T.top_level(acc) == {"gather_packed": 3.0,
                                "batch_assemble": 2.0,
                                "chain_enqueue": 1.0, "host_sync": 1.0}


# ---- the benchmark's readers ---------------------------------------------

TICKS = 4
TIMERS = {"gather_packed": 0.080, "gather.pop": 0.010, "gather.read": 0.030,
          "gather.feed": 0.006, "gather": 0.004, "batch_assemble": 0.016,
          "upload": 0.003, "chain_enqueue": 0.002, "host_sync": 0.006,
          "readback": 0.0025}
# what the parent's fleet times: no nested span
PARENT_TIMERS = {"gather_packed": 0.080, "gather": 0.004,
                 "batch_assemble": 0.016, "device_chain": 0.002,
                 "host_sync": 0.006}
CHAIN_DEV = [dict(scan=0.010, composite=0.005, sbc=0.002, pdm=0.0016,
                  outs=0.0004, span=0.031, **{"idct+compose": 0.012}),
             dict(scan=0.011, composite=0.006, sbc=0.002, pdm=0.0014,
                  outs=0.0006, span=0.033, **{"idct+compose": 0.012})]
FLEET_COUNTS = [{"feed.bytes_read": 14_000_000, "feed.rounds": 10,
                 "feed.lane_ticks": 2048, "feed.underruns": 0,
                 "feed.mapped_bytes": 13_900_000},
                {"feed.bytes_read": 14_100_000, "feed.rounds": 11,
                 "feed.lane_ticks": 2048, "feed.underruns": 4,
                 "feed.mapped_bytes": 14_100_000}]
# name: (value over the fabricated stretch, read from records?)
READERS = {
    "chain.scan_ms": (1e3 * 0.021 / TICKS, True),
    "chain.decode_ms": (1e3 * 0.024 / TICKS, True),
    "chain.composite_ms": (1e3 * 0.011 / TICKS, True),
    "chain.audio_ms": (1e3 * 0.007 / TICKS, True),
    "served.chain_ms": (1e3 * 0.064 / TICKS, True),
    "served.read_kb": (28_100.0 / TICKS, True),
    "served.pump_rounds": (21 / TICKS, True),
    "served.underrun_pct": (100 * 4 / 4096, True),
    "served.mapped_pct": (100 * 28_000_000 / 28_100_000, True),
    "served.readback_ms": (1e3 * 0.0025 / TICKS, False),
    "served.upload_ms": (1e3 * 0.003 / TICKS, False),
    "served.feed_read_ms": (1e3 * 0.030 / TICKS, False),
    "served.feed_pop_ms": (1e3 * 0.016 / TICKS, False),
    "served.gather_self_ms": (1e3 * 0.034 / TICKS, False),
}


@pytest.fixture
def stretch(monkeypatch):
    """A traced stretch of two chunks of two ticks, each with a "chain"
    and a "fleet" record (the chain's resolved when read), after an
    older chunk of another run."""
    monkeypatch.setattr(T, "RECORDS", deque(maxlen=256))
    T.record("chain", 2, device={k: 1.0 for k in CHAIN_DEV[0]})
    T.record("fleet", 2, counters=dict(FLEET_COUNTS[0], **{
        "feed.underruns": 2048}))
    for dev, counts in zip(CHAIN_DEV, FLEET_COUNTS):
        T.record("chain", 2, device=lambda dev=dev: dict(dev))
        T.record("fleet", 2, counters=counts)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_its_spans_or_records(stretch, name):
    from espbench.manifest import Benchmark
    reader = Benchmark().reader(name)
    want, from_records = READERS[name]
    ctx = {"ticks": TICKS, "timers_s": dict(TIMERS)}
    assert reader.read(ctx) == pytest.approx(want, rel=1e-12)
    if from_records:
        # the stretch's records do not sum to its ticks
        assert reader.read(dict(ctx, ticks=TICKS - 1)) is None
        assert reader.read(dict(ctx, ticks=0)) is None
    else:
        assert reader.read(dict(ctx, timers_s=dict(PARENT_TIMERS))) is None
        assert reader.read(dict(ctx, timers_s={})) is None


def test_mapped_pct_reads_nothing_without_its_counter(monkeypatch):
    """A stretch whose "fleet" records hold no feed.mapped_bytes (a
    program that maps nothing) or fed no byte reads nothing."""
    from espbench.manifest import Benchmark
    reader = Benchmark().reader("served.mapped_pct")
    for counts in ({"feed.bytes_read": 14_000_000},
                   {"feed.bytes_read": 0, "feed.mapped_bytes": 0}):
        monkeypatch.setattr(T, "RECORDS", deque(maxlen=256))
        T.record("fleet", 2, counters=dict(counts))
        T.record("fleet", 2, counters=dict(counts))
        assert reader.read({"ticks": 4, "timers_s": dict(TIMERS)}) is None


@pytest.mark.gpu
def test_chain_record_stages_sum_to_its_span_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from espflix_tpu_torch.models import mpeg1 as M
    from espflix_tpu_torch.models import sbc as dsbc
    from espflix_tpu_torch.ops import delta_sigma as DS
    from espflix_tpu_torch.runtime import chain as CH
    from espflix_tpu_torch.runtime.workload import bench_chunk
    dev = torch.device("cuda", 0)
    lanes, n_pics = 256, 4
    xs_np, kw, _slide = bench_chunk(lanes, n_pictures=n_pics, distinct=4)
    xs = CH.xs_to_torch(xs_np, dev)
    mbw, mbh = kw["mb_width"], kw["mb_height"]
    state = (M.init_frame_state(lanes, mbw * 16, mbh * 16, dev),
             dsbc.init_state(lanes, dev), DS.init_state(lanes, dev))
    tap_idx = torch.zeros(1, dtype=torch.int32, device=dev)
    CH.run_full_chunk(xs, *state, tap_idx, None, tap=0,
                      return_planes=False, **kw)            # warm-up
    acts = CPU + [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        CH.run_full_chunk(xs, *state, tap_idx, None, tap=0,
                          return_planes=False, **kw)
    torch.cuda.synchronize()
    (rec,) = T.traced("chain", n_pics)
    d = rec["device"]
    assert all(d[s] > 0 for s in T.STAGES)
    parts = sum(d[s] for s in T.STAGES) + d["outs"]
    assert abs(parts - d["span"]) <= 0.01 * d["span"]
