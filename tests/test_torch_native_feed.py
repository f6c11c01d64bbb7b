"""The port's native session feed (streaming/native_feed.py) and the
fleet's batched and packed pops, against the port's Python StreamFeed
and the JAX package's native feed.

  * NativeStreamFeed: the same PictureData (payload, slices, seq, pts)
    and SBC frames as the port's StreamFeed and the JAX NativeStreamFeed
    on bulk, packet-sized and ragged chunks, and on a sequence header
    split mid-header (as tests/test_split_seq_header.py does for JAX);
  * FeedPool: lanes recycle under churn and start clean;
  * pop_many: Fleet._gather_pictures' batched pops equal per-lane pops
    and the JAX fleet's batched gather;
  * pop_many_packed: Fleet._gather_batch_packed's batch dict equals
    make_picture_batch of the classic gather and the JAX packed dict,
    tick for tick, and logs the classic gather's events in its order,
    also when lanes are parked or resynced;
  * mapped title reads (streaming/title_maps.py): the packed gather
    reading from file mappings gives what it gives on Streamer.read --
    batches, pts, flags, states, SBC rows, events and feed counts --
    from ranged opens, through seeks, pauses and trick play, to the
    titles' ends; a lane taken off the mappings reads on from the byte
    after the last mapped read;
  * the native pump (streaming/native_pump.py): the packed gather with
    the mapped lanes' pump rounds in one threaded native call gives
    what the round loop on Streamer.read gives -- batches, pts, flags,
    states, SBC rows, events and every feed counter but the mappings'
    own -- in plain play, with lanes ending mid-tick, trick lanes
    beside one-round lanes, seeks, oversize pictures and lanes off the
    mappings in the same tick; on one thread or many, more than the
    host has cores; a failed build of the pump raises.

Exact equality throughout (bytes and integers).  The port's feeds and
the JAX package's share native/libespflix_native.so, each with its own
FeedPool.
"""

import gc
import threading

import numpy as np
import pytest
import torch

from espflix_tpu.runtime import session as JSES
from espflix_tpu.streaming import native_feed as JNF
from espflix_tpu.tools import serve_scenario as JSS
from espflix_tpu_torch.models import mpeg1 as TM
from espflix_tpu_torch.runtime import scheduler as TSCH
from espflix_tpu_torch.runtime import session as TSES
from espflix_tpu_torch.runtime.player import READ_CHUNK
from espflix_tpu_torch.streaming import native_feed as TNF
from espflix_tpu_torch.streaming import native_pump as TNP
from espflix_tpu_torch.streaming import title_maps as TMAPS
from espflix_tpu_torch.streaming.streamer import Streamer
from espflix_tpu_torch.tools import serve_scenario as TSS

torch.set_num_threads(1)



@pytest.fixture(autouse=True, scope="module")
def native_lib():
    """The native library, built at first use (not at collection)."""
    if not TNF.available():
        pytest.skip("native lib not built")


@pytest.fixture(scope="module")
def service(tmp_path_factory):
    root = tmp_path_factory.mktemp("svc_nf")
    TSS.generate_service(str(root), ["a", "b"], seed=9, n_gops=2, gop=6)
    return root


def _probe(data: bytes):
    return TSCH.Fleet._sbc_probe(data)


def _drain(feed, ts: bytes, chunks, audio_every=3, max_audio=8):
    """Feed `ts` in the given chunk sizes, popping pictures eagerly and
    audio every few chunks; returns (pictures, audio arrays)."""
    pics, audio = [], []
    pos = 0
    for k, c in enumerate(chunks, 1):
        feed.feed(ts[pos:pos + c])
        pos += c
        while (p := feed.pop_picture()) is not None:
            pics.append(p)
        if k % audio_every == 0 and \
                feed.audio.discover(_probe) and feed.audio.frame_size:
            fa = feed.audio.pop_frames_array(max_audio)
            if fa is not None:
                audio.append(fa.copy())
    assert pos == len(ts)
    feed.eos()
    while (p := feed.pop_picture()) is not None:
        pics.append(p)
    if feed.audio.discover(_probe) and feed.audio.frame_size:
        fa = feed.audio.pop_frames_array(4096)
        if fa is not None:
            audio.append(fa.copy())
    return ([(p.pic_type, p.full_pel, p.r_size, p.pts, p.payload,
              list(p.slice_offsets), list(p.slice_rows), p.seq.width,
              p.seq.height, p.seq.intra_q.tolist(),
              p.seq.non_intra_q.tolist()) for p in pics],
            np.concatenate([a.reshape(-1) for a in audio])
            if audio else np.zeros(0, np.uint8))


def _chunks(n, mode):
    if mode == "bulk":
        return [n]
    if mode == "packets":
        c = [188 * 4] * (n // (188 * 4))
        return c + ([n - sum(c)] if n - sum(c) else [])
    rng = np.random.default_rng(3)     # ragged: splits everything
    out = []
    while n > 0:
        out.append(min(int(rng.integers(1, 601)), n))
        n -= out[-1]
    return out


@pytest.mark.parametrize("mode", ["bulk", "packets", "ragged"])
def test_native_feed_matches(service, mode):
    ts = (service / "media" / "a" / "video.ts").read_bytes()
    chunks = _chunks(len(ts), mode)
    got = _drain(TNF.NativeStreamFeed(), ts, chunks)
    py = _drain(TSES.StreamFeed(), ts, chunks)
    jx = _drain(JNF.NativeStreamFeed(), ts, chunks)
    assert len(got[0]) == 12 and len(got[1]) > 0
    assert got[0] == py[0] == jx[0]
    assert np.array_equal(got[1], py[1]) and np.array_equal(got[1], jx[1])


@pytest.mark.parametrize("mk", [TSES.StreamFeed, TNF.NativeStreamFeed])
def test_seq_header_split_mid_header(service, mk):
    """The first sequence header's code starts at TS offset 18; a cut a
    few bytes into it leaves geometry and load flags for the next feed
    (tests/test_split_seq_header.py)."""
    ts = (service / "media" / "a" / "video.ts").read_bytes()
    ref = mk()
    ref.feed(ts)
    q = ref.pop_picture()
    jref = JSES.StreamFeed()
    jref.feed(ts)
    jq = jref.pop_picture()
    assert (q.seq.width, q.seq.height, q.payload) == \
        (jq.seq.width, jq.seq.height, jq.payload)
    for cut in (23, 24, 26, 29):
        feed = mk()
        feed.feed(ts[:cut])
        assert feed.pop_picture() is None
        feed.feed(ts[cut:])
        p = feed.pop_picture()
        assert (p.seq.width, p.seq.height) == (q.seq.width, q.seq.height)
        assert np.array_equal(p.seq.intra_q, q.seq.intra_q)
        assert np.array_equal(p.seq.non_intra_q, q.seq.non_intra_q)
        assert p.payload == q.payload


def test_pool_recycles_lanes_under_churn():
    """A session makes a fresh feed per play(): the port's pool lanes
    recycle (no leak), a recycled lane starts clean, and the JAX
    package's pool is a different one."""
    pool = TNF.get_pool()
    assert pool is not JNF.get_pool() and pool.handle != JNF.get_pool().handle
    gc.collect()            # feeds of earlier tests' sessions, in cycles
    free0 = len(pool._free)
    for _ in range(3):
        feeds = [TNF.NativeStreamFeed() for _ in range(128)]
        for fd in feeds:
            fd.feed(b"\x47" + b"\x00" * 187)
        assert len(pool._free) == free0 - 128
        del feeds, fd
        gc.collect()
        assert len(pool._free) == free0
    f = TNF.NativeStreamFeed()
    assert f.pop_picture() is None and not f.sync_lost
    assert f.audio.size() == 0
    del f
    gc.collect()
    assert len(pool._free) == free0


def test_player_session_uses_native(service, monkeypatch):
    from espflix_tpu_torch.runtime.player import PlayerSession
    monkeypatch.delenv("ESPFLIX_NATIVE_FEED", raising=False)
    s = PlayerSession("file://" + str(service))
    assert s.init_service()
    s.nav(0)
    s.play_pause()
    assert isinstance(s.feed, TNF.NativeStreamFeed)
    assert sum(s.next_picture() is not None for _ in range(8)) == 8
    monkeypatch.setenv("ESPFLIX_NATIVE_FEED", "0")
    assert isinstance(TSES.make_stream_feed(), TSES.StreamFeed)


def _port_fleet(service, lanes=8, **kw):
    return TSS.build_fleet("file://" + str(service), lanes, 2,
                           device="cpu", **kw)


def _events(fleet):
    return [(e.ev.name, e.lane, e.value)
            for e in fleet.events.dump(10 ** 6)]


def _gather_run(fleet, ticks=20):
    seqs = []
    for _ in range(ticks):
        pics, pts, pre = fleet._gather_pictures()
        seqs.append(([(p.pic_type, p.pts, p.payload) if p else None
                      for p in pics], pts.tolist(), pre.tolist(),
                     [s.state.name for s in fleet.sessions]))
    return seqs


def test_batched_pop_matches_per_lane(service, monkeypatch):
    """_gather_pictures through pop_many (one call a pump round) gives
    the pictures, states and events of the JAX fleet's gather, both
    per lane (the JAX package's ESPFLIX_BATCHED_POP=0) and batched."""
    fleet = _port_fleet(service)
    got = (_gather_run(fleet), _events(fleet))
    for batched in ("0", "1"):
        monkeypatch.setenv("ESPFLIX_BATCHED_POP", batched)
        jf = JSS.build_fleet("file://" + str(service), 8, 2,
                             words_per_lane=8192)
        assert got == (_gather_run(jf), _events(jf)), batched
    # pictures came, then every title ran out (the EOS path)
    assert sum(p is not None for t in got[0] for p in t[0]) == 8 * 12
    assert set(got[0][-1][3]) == {"DONE"}


def _packed_run(fleet, M, ticks=20, classic=False):
    """The batch dicts, pts, flags and states of `ticks` ticks of
    run_chunk_full's gather; `classic`: of _gather_pictures +
    make_picture_batch alone."""
    out = []
    for _ in range(ticks):
        g = None if classic else fleet._gather_batch_packed()
        if g is not None:
            b, pts, pre = g
        else:
            pics, pts, pre = fleet._gather_pictures()
            b = M.make_picture_batch(
                pics, words_per_lane=fleet.words_per_lane,
                max_slices=fleet.mb_h, geometry=(fleet.mb_w, fleet.mb_h))
        b = {k: (v.copy() if isinstance(v, np.ndarray) else v)
             for k, v in b.items()}
        out.append((b, np.asarray(pts).copy(), pre.copy(),
                    [s.state.name for s in fleet.sessions]))
    return out


def _assert_batches_equal(A, B):
    saw_active = False
    for t, ((ba, pa, ea, sa), (bb, pb, eb, sb)) in enumerate(zip(A, B)):
        assert sa == sb and np.array_equal(pa, pb), t
        assert np.array_equal(ea, eb), t
        for k in ("active", "pic_type", "full_pel", "r_size", "n_slices",
                  "n_words"):
            assert np.array_equal(ba[k], bb[k]), (t, k)
        act = ba["active"]
        saw_active |= bool(act.any())
        for k in ("words", "slice_starts", "slice_rows", "intra_q",
                  "non_intra_q"):
            assert np.array_equal(ba[k][act], bb[k][act]), (t, k)
    assert saw_active and len(A) == len(B)


def test_packed_gather_matches_classic_and_jax(service):
    """pop_many_packed's batch dict == make_picture_batch of the classic
    gather == the JAX PackedBatch dict, tick for tick (active rows
    including their zero tails), with the same pts, flags, states."""
    from espflix_tpu.models import mpeg1 as JM
    runs = []
    for classic in (False, True):
        fleet = _port_fleet(service, stage="full")
        runs.append((_packed_run(fleet, TM, classic=classic),
                     fleet._packed is not None, _events(fleet)))
    jf = JSS.build_fleet("file://" + str(service), 8, 2,
                         words_per_lane=8192, stage="full")
    jrun = _packed_run(jf, JM)
    (got, used, ev), (classic, unused, ev_c) = runs
    assert used and not unused and jf._packed is not None
    _assert_batches_equal(got, classic)
    _assert_batches_equal(got, jrun)
    assert ev == ev_c


@pytest.mark.parametrize("case", ["oversize", "geometry"])
def test_packed_policies_log_the_classic_events(service, case):
    """Lanes whose pictures the fleet rejects -- more words than a lane
    holds (LANE_OVERSIZE, then LANE_RESYNC) or another geometry
    (LANE_GEOMETRY, parked) -- log the classic gather's events in its
    order through the packed path, with the same batches."""
    kw = dict(words_per_lane=2048) if case == "oversize" else {}
    runs = []
    for classic in (False, True):
        fleet = _port_fleet(service, stage="full", **kw)
        if case == "geometry":
            fleet.height = 176      # every 352x192 picture mismatches
        runs.append((_packed_run(fleet, TM, ticks=8, classic=classic),
                     _events(fleet)))
    (got, ev), (classic, ev_c) = runs
    name = "LANE_OVERSIZE" if case == "oversize" else "LANE_GEOMETRY"
    assert sum(e[0] == name for e in ev) >= 2
    assert ev == ev_c
    for (ba, pa, ea, sa), (bb, pb, eb, sb) in zip(got, classic):
        assert sa == sb and np.array_equal(pa, pb) and np.array_equal(ea, eb)
        for k in ("active", "pic_type", "n_slices", "n_words"):
            assert np.array_equal(ba[k], bb[k]), k


# ---- mapped title reads ------------------------------------------------

def _served_run(fleet, ticks, act=None):
    """run_chunk_full's host gather, tick by tick: per tick the batch
    dict, pts, pre_errors, session states and SBC rows; then the events
    and the feed counters but feed.mapped_bytes and feed.attaches (the
    title mappings' own).  act(t, fleet) runs before tick t (control
    between ticks, as between chunks)."""
    out = []
    for t in range(ticks):
        if act is not None:
            act(t, fleet)
        (b, pts, pre, states), = _packed_run(fleet, TM, ticks=1)
        sbc = fleet._gather_audio_arrays(fleet.audio_F)[:4]
        out.append((b, pts, pre, states, [a.copy() for a in sbc]))
    counts = {k: v for k, v in fleet.counters.items()
              if k not in ("feed.mapped_bytes", "feed.attaches")}
    return out, _events(fleet), counts


def _assert_runs_equal(a, b):
    (ta, ev_a, ca), (tb, ev_b, cb) = a, b
    _assert_batches_equal([t[:4] for t in ta], [t[:4] for t in tb])
    for t, (x, y) in enumerate(zip(ta, tb)):
        assert all(np.array_equal(p, q) for p, q in zip(x[4], y[4])), t
    assert ev_a == ev_b and ca == cb


def _ranged(t, fleet):
    """Before the first tick: each lane reopens its title through a
    ranged open, from its start or its second GOP, to its end or for
    150 packets (a short last read, then EOS before the file's end)."""
    if t:
        return
    for i, s in enumerate(fleet.sessions):
        off = (i % 2) * 188 * s.get_index(0, 18000)
        assert s.streamer.get(s.folder(s.nav_index) + "/video.ts", off,
                              (i // 2 % 2) * 188 * 150) == 0


def _controls(t, fleet):
    """Seeks, a pause and its resume, trick play and a resync between
    ticks: lanes reopen their files, or leave and rejoin the fast path
    with the same file open."""
    S = fleet.sessions
    {2: lambda: (S[0].skip(0), S[2].play_pause()),
     3: lambda: S[1].fast_forward(),
     4: lambda: (S[3].rewind(), S[4].resync()),
     6: lambda: (S[2].play_pause(), S[5].skip(0)),
     9: lambda: S[1].play_pause()}.get(t, lambda: None)()


@pytest.mark.parametrize("act", [_ranged, _controls])
def test_mapped_reads_match_streamer_reads(service, monkeypatch, act):
    """The packed gather on the title mappings == the same gather on
    Streamer.read (file_key refusing every file), tick for tick, until
    every lane has played its stream to the end."""
    attached = []
    attach = TMAPS.TitleMaps._attach

    def spy(self, i, st):
        ok = attach(self, i, st)
        attached.append(ok)
        return ok
    monkeypatch.setattr(TMAPS.TitleMaps, "_attach", spy)
    fleet = _port_fleet(service, stage="full")
    mapped = _served_run(fleet, 24, act)
    c = fleet.counters
    assert c["feed.mapped_bytes"] == c["feed.bytes_read"] > 0
    n_attached = sum(attached)
    monkeypatch.setattr(TMAPS, "file_key", lambda f: None)
    fleet = _port_fleet(service, stage="full")
    plain = _served_run(fleet, 24, act)
    assert fleet.counters["feed.mapped_bytes"] == 0
    assert not any(attached[n_attached:])
    _assert_runs_equal(mapped, plain)
    assert set(mapped[0][-1][3]) == {"DONE"}
    if act is _controls:
        # the reopened and resumed lanes attached again
        assert n_attached >= 8 + 6


def test_detached_lane_reads_on_after_the_mapped_bytes(service,
                                                       monkeypatch):
    """Lane 0's pump patched after three ticks takes it off the
    mappings: its Streamer reads on from the byte after the last mapped
    read, the title's bytes in order, and every lane's pictures are
    those of a run on Streamer.read throughout."""
    runs = []
    for mapped in (True, False):
        if not mapped:
            monkeypatch.setattr(TMAPS, "file_key", lambda f: None)
        reads, cursor = [], []

        def act(t, fleet, reads=reads, cursor=cursor):
            if t != 3:
                return
            s = fleet.sessions[0]
            st = s.streamer
            cursor.append(int(fleet._titles.pos[0])
                          if fleet._titles.src[0] >= 0 else None)

            def pump():
                pos = st._offset + st._mark
                assert st._file.tell() == pos
                data = st.read(READ_CHUNK)
                reads.append((pos, data))
                if not data:
                    s.feed.eos()
                    s.eos = True
                    return False
                s.bytes_read += len(data)
                s.feed.feed(data)
                return True
            s.pump = pump
        fleet = _port_fleet(service, stage="full")
        runs.append(_served_run(fleet, 20, act))
        path = fleet.sessions[0].streamer._file.name
        if mapped:
            title = open(path, "rb").read()
            first, pos = cursor[0], cursor[0]
            assert 0 < first < len(title)
            for p, data in reads:
                assert p == pos and data == title[pos:pos + len(data)]
                pos += len(data)
            assert reads[0][0] == first and pos == len(title)
            mapped_reads = reads
        else:
            assert cursor == [None] and reads == mapped_reads
    _assert_runs_equal(*runs)


# ---- the native pump -----------------------------------------------------

def _oversize(t, fleet):
    """Lanes hold 3,456 words: of the I pictures (13.4-13.9 KB) those
    past 13,808 bytes do not fit the packed pop (rc < 0; LANE_OVERSIZE,
    then a resync), the others play."""
    if t == 0:
        fleet.words_per_lane = 3456


def _mixed(t, fleet):
    """Lanes off the mappings beside mapped ones from the first tick: a
    patched pump (lane 0), a get_rom buffer (lane 3) and a Streamer
    whose read is overridden (lane 6)."""
    if t:
        return
    S = fleet.sessions
    S[0].pump = lambda orig=S[0].pump: orig()
    S[3].play_rom(Streamer().get_url(S[3].folder(S[3].nav_index)
                                     + "/video.ts"))
    st = S[6].streamer
    st.read = lambda n, orig=st.read: orig(n)


def _pump_runs(service, monkeypatch, act, threads=3):
    """The packed gather's run on the native pump (`threads` threads a
    call) and on the round loop over Streamer.read (file_key refusing
    every file); the pump's calls, as (lanes, threads, capacity rcs,
    lanes ended)."""
    calls = []
    run = TNP.Pump.run

    def spy(self, *a, **kw):
        r = run(self, *a, **kw)
        calls.append((len(r.rc), r.threads, int((r.rc < 0).sum()),
                      int(r.ended.sum())))
        return r
    monkeypatch.setattr(TNP.Pump, "run", spy)
    with monkeypatch.context() as mp:
        mp.setattr(TNP, "_threads", lambda n: threads)
        pumped = _served_run(_port_fleet(service, stage="full"), 24, act)
    n_calls = len(calls)
    with monkeypatch.context() as mp:
        mp.setattr(TMAPS, "file_key", lambda f: None)
        plain = _served_run(_port_fleet(service, stage="full"), 24, act)
    assert len(calls) == n_calls        # nothing mapped, no pump call
    return pumped, plain, calls


@pytest.mark.parametrize("act", [None, _ranged, _controls, _oversize,
                                 _mixed])
def test_native_pump_matches_the_round_loop(service, monkeypatch, act):
    """The mapped lanes' pump rounds in one threaded native call == the
    round loop on Streamer.read (every feed counter but the mappings'),
    tick for tick, until every lane has played its stream to the end."""
    pumped, plain, calls = _pump_runs(service, monkeypatch, act)
    _assert_runs_equal(pumped, plain)
    if act is not _oversize:        # a resync plays its title on
        assert set(pumped[0][-1][3]) == {"DONE"}
    assert any(t > 1 for _, t, *_ in calls)
    # lanes ran into their streams' ends inside the pump
    assert sum(e for *_, e in calls) > 0
    ev = pumped[1]
    if act is _oversize:
        assert sum(x for _, _, x, _ in calls) >= 2
        assert sum(e[0] == "LANE_OVERSIZE" for e in ev) >= 2
    if act is _mixed:
        # 5 of the 8 lanes on the mappings
        assert all(n == 5 for n, *_ in calls[:3])


def _threaded(fn, timeout=120):
    """fn() on a thread of its own, joined within `timeout` seconds."""
    out = []
    t = threading.Thread(target=lambda: out.append(fn()), daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), "the pump did not return"
    return out[0]


def _staggered(t, fleet):
    """Lanes start 0-10 pictures into their titles (so no two lanes'
    pops look alike), then _controls' seeks and trick play."""
    if t == 0:
        for i, s in enumerate(fleet.sessions):
            for _ in range(i % 11):
                assert s.next_picture() is not None
    _controls(t, fleet)


@pytest.mark.parametrize("threads", [1, 4, 48])
def test_native_pump_threads_give_one_result(service, monkeypatch,
                                             threads):
    """256 lanes at staggered places, through seeks and trick play, on 1,
    4 or 48 threads a call (48: more than the host has cores) give the
    single-threaded round loop's run on Streamer.read, and each call
    returns."""
    runs, took = [], []
    run = TNP.Pump.run

    def spy(self, *a, **kw):
        r = run(self, *a, **kw)
        took.append((len(r.rc), r.threads))
        return r
    for mapped in (True, False):
        with monkeypatch.context() as mp:
            if mapped:
                mp.setattr(TNP, "_threads", lambda n: threads)
                mp.setattr(TNP.Pump, "run", spy)
            else:
                mp.setattr(TMAPS, "file_key", lambda f: None)
            fleet = _port_fleet(service, lanes=256, stage="full")
            runs.append(_threaded(lambda: _served_run(fleet, 24,
                                                      _staggered)))
    _assert_runs_equal(*runs)
    assert took[0] == (256, threads)
    assert all(t == min(threads, n) for n, t in took)


def test_a_failed_pump_build_raises(service, monkeypatch):
    """Where the pump library cannot be built, the packed gather of
    mapped lanes raises the build's error: it does not serve them some
    other way."""
    def broken():
        raise RuntimeError("g++ failed")
    monkeypatch.setattr(TNP, "_pump", None)
    monkeypatch.setattr(TNP, "_lib", None)
    monkeypatch.setattr(TNP, "build", broken)
    fleet = _port_fleet(service, stage="full")
    with pytest.raises(RuntimeError, match="g.. failed"):
        fleet._gather_batch_packed()
