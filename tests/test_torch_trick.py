"""Trick play on the port's served path against the benchmark's plain
reference (espbench/reference/trick.py), on a tiny title with
upstream-shaped trick streams (espbench/content/trick.py: 180 main
pictures in GOPs of 4 with SBC audio; forward and rewind streams of 12
pictures in closed GOPs of 3, no audio; video.idx over the three).

  * the index: the port's streaming/index offsets, packet reads and
    trick-to-main PTS mapping equal the reference's at every bin of each
    stream and past both ends; and a PlayerSession's first picture
    after fast-forward, rewind, the PLAY that leaves them, UP and DOWN,
    from positions across the title and at both its ends, is the
    picture the reference lands on;
  * Fleet.apply_keys: a full-chain CPU fleet driven through FF, RWD,
    PLAY-return, UP and DOWN presents the reference's PTS, planes and
    field checksums, and counts the keys, seeks, trick lane-ticks,
    title-map attaches and seek waits the schedule implies;
  * churn: more seeks than the native feed pool has lanes leave every
    lane on the native fast path (no silent Python-feed fallback).
"""

import numpy as np
import pytest
import torch

from espflix_tpu_torch.runtime import input as INP
from espflix_tpu_torch.runtime.player import PlayerSession, State
from espflix_tpu_torch.runtime.scheduler import Fleet
from espflix_tpu_torch.streaming import index as IDX
from espflix_tpu_torch.streaming import native_feed as NF
from espflix_tpu_torch.streaming.streamer import Streamer

from espbench.content import trick as content
from espbench.content.sbc_encode import random_frame
from espbench.reference import composite as RC
from espbench.reference import media
from espbench.reference import trick as RT

torch.set_num_threads(1)

PER = 3000
GOP = 4
KEYS = {"RIGHT": INP.KEY_RIGHT, "LEFT": INP.KEY_LEFT,
        "PLAY": INP.KEY_PLAY, "UP": INP.KEY_UP, "DOWN": INP.KEY_DOWN}


@pytest.fixture(scope="module")
def service(tmp_path_factory):
    """One title: 3 encoded GOPs of 4 played 15 times (180 pictures, 6
    s), trick streams of 2 GOPs of 3 played twice (12 pictures)."""
    root = tmp_path_factory.mktemp("svc_trick")
    arng = np.random.default_rng(11)
    audio = [(random_frame(arng, mode=0, bitpool=28), k * 240)
             for k in range(3 * GOP * PER // 240)]
    files, es = content.make_title(
        np.random.default_rng(12), np.random.default_rng(13), audio,
        n_gops=3, gop=GOP, repeat=15, speed=15, trick_gop=3,
        trick_unique=2)
    d = root / "media" / "t"
    d.mkdir(parents=True)
    for name, data in files.items():
        (d / name).write_bytes(data)
    (root / "manifest.txt").write_text("t\n")
    title = RT.Title(files["video.idx"], {
        0: files["video.ts"], 1: files["video_fwd.ts"],
        -1: files["video_rwd.ts"]})
    return "file://" + str(root), title, files, es


def _session(url, pos):
    s = PlayerSession(url)
    assert s.init_service()
    s.nav(0)
    s.info[0].pos = pos
    s.play_pause()
    return s


def _first_pts(s):
    p = s.next_picture()
    s.on_presented(p.pts)
    return p.pts


def test_index_math_and_reads_match_the_reference(service):
    url, title, files, _es = service
    hdr = IDX.IdxHdr.unpack(files["video.idx"])
    ref = title.index
    v0, v1 = ref.rec[0][:2]
    folder = url + "/media/t/video.idx"
    positions = list(range(v0 - 2 * PER, v1 + 40 * 90000, 7500 // 2))
    for speed in (0, 1, -1):
        for pos in positions:
            assert hdr.pts2offset(pos, speed) == ref.pts2offset(pos, speed)
        for pos in positions[::7]:
            assert IDX.get_index(Streamer(), folder, hdr, speed, pos) == \
                ref.packet(speed, pos)
    for speed in (1, -1):
        t0, t1 = ref.rec[speed][:2]
        for pts in range(t0, t1 + PER, PER):
            assert hdr.pts2pts(pts, speed) == ref.pts2pts(pts, speed)


STARTS = [0, 40 * PER, 88 * PER, 150 * PER, 179 * PER]


@pytest.mark.parametrize("key", ["RIGHT", "LEFT", "UP", "DOWN"])
def test_a_sessions_landings_are_the_references(service, key):
    """From each start (both ends of the title among them): the first
    picture after the key, then after a PLAY that leaves trick play four
    pictures on, as the reference's lane lands."""
    url, title, _f, _es = service
    for pos in STARTS:
        s = _session(url, pos)
        lane = RT.Lane(PER)
        lane.start(title, pos)
        assert _first_pts(s) == lane.next_pts
        lane.present()
        INP.dispatch_key(s, KEYS[key])
        assert lane.key(KEYS[key])
        assert s.speed == lane.speed and s.state.name == lane.state
        for _ in range(4):
            p = s.next_picture()
            if p is None:
                # played past its stream's end
                assert lane.exhausted and s.state == State.DONE
                lane.idle_tick()
                break
            assert p.pts == lane.next_pts, (pos, key)
            s.on_presented(p.pts)
            lane.present()
        if lane.speed and lane.state != RT.DONE:
            INP.dispatch_key(s, INP.KEY_PLAY)
            assert lane.key(INP.KEY_PLAY)
            assert s.state == State.PLAYING
            assert _first_pts(s) == lane.next_pts, (pos, key)
            lane.present()
        assert s.info[0].pos == lane.pos


# (chunk, {lane: key}) of the fleet test; lanes start at GOPs 0, 10, 20,
# 30 of the title
SCHEDULE = {1: {0: "RIGHT", 1: "LEFT", 2: "UP", 3: "DOWN"},
            2: {0: "PLAY", 1: "PLAY"}}
K = 2


@pytest.fixture(scope="module")
def fleet_run(service):
    url, title, _f, es = service
    n = 4
    f = Fleet(n, words_per_lane=8192, parser="pallas", output=True,
              device="cpu", audio_frames_per_tick=1)
    lanes = []
    for i in range(n):
        pos = i * 10 * GOP * PER
        f.attach(i, _session(url, pos))
        lanes.append(RT.Lane(PER))
        lanes[-1].start(title, pos)
    chunks = []
    for c in range(3):
        keys = {i: KEYS[k] for i, k in SCHEDULE.get(c, {}).items()}
        f.apply_keys(keys)
        for i, key in keys.items():
            assert lanes[i].key(key)
        speeds = [L.speed for L in lanes]
        rs = f.run_chunk_full(K)
        want = []
        for r in rs:
            want.append([L.next_pts if r.video_lanes[i] else -1
                         for i, L in enumerate(lanes)])
            for i, L in enumerate(lanes):
                if r.video_lanes[i]:
                    L.present()
        chunks.append((speeds, rs, want))
    pics = {sp: media.decode_stream(e)[0]
            for sp, e in zip((0, 1, -1), es)}
    return f, chunks, pics


def test_apply_keys_presents_the_references_pictures(fleet_run):
    _f, chunks, pics = fleet_run
    for speeds, rs, want in chunks:
        for r, w in zip(rs, want):
            assert r.video_lanes.all()
            assert r.pts.tolist() == w
            for i, sp in enumerate(speeds):
                q = pics[sp]
                y, u, v = (torch.as_tensor(a)[None] for a in
                           q[r.pts[i] // PER % len(q)])
                assert torch.equal(r.y[i], y[0])
                assert torch.equal(r.u[i], u[0])
                assert torch.equal(r.v[i], v[0])
                z = torch.zeros(1, dtype=torch.int32)
                _ff, fs = RC.field_pair(
                    y, u, v, z, torch.zeros((1, 16, 80), dtype=torch.uint8),
                    z, z, pal=False)
                assert int(fs[0]) == int(r.field_sum[i])


def test_apply_keys_counts_what_the_schedule_implies(fleet_run):
    f, _chunks, _pics = fleet_run
    c = f.counters
    keys = sum(map(len, SCHEDULE.values()))
    assert c["control.keys"] == c["control.seeks"] == keys
    # every seek presents on its first tick
    assert c["control.seek_wait"] == keys
    # lanes 0 and 1 fast-forward and rewind through chunk 1
    assert c["feed.trick_lane_ticks"] == 2 * K
    # four lanes at the first tick, then each reopened lane once
    assert c["feed.attaches"] == 4 + keys
    assert c["feed.slow_lane_ticks"] == 0
    assert set(f.timers.n) >= {"control"} and f.timers.n["control"] == 3


def test_seeks_beyond_the_pools_lanes_stay_native(service, monkeypatch):
    """Two lanes on a native feed pool of six lanes seek 24 times (a
    stream reopened, a fresh native feed, each time): every lane-tick
    stays on the fast path and the pool ends with its lanes free but
    the two in use."""
    url, _t, _f, _es = service
    monkeypatch.setattr(NF, "_pool", NF.FeedPool(6))
    f = Fleet(2, words_per_lane=8192, parser="pallas", output=True,
              device="cpu", audio_frames_per_tick=1)
    for i in range(2):
        f.attach(i, _session(url, 30 * PER * i))
    cycle = ["RIGHT", "PLAY", "UP", "LEFT", "PLAY", "DOWN"]
    for t in range(12):
        f.apply_keys({i: KEYS[cycle[(t + 3 * i) % len(cycle)]]
                      for i in range(2)})
        assert f._gather_batch_packed() is not None
    c = f.counters
    assert c["control.seeks"] == 24
    assert c["feed.slow_lane_ticks"] == 0
    assert all(isinstance(s.feed, NF.NativeStreamFeed)
               for s in f.sessions)
