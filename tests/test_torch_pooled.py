"""Pooled serving on the served path's own gather, on the CPU.

A HostPool worker gathers its lanes through the packed gather the
in-process Fleet uses (runtime/packed_gather.py): four lanes on two
workers over three ticks -- file:// lanes on the title mappings, a lane
over a get_rom buffer, a lane whose first picture is too big for a lane
and is dropped and re-seeked -- give, lane for lane, the chain inputs
in-process Fleet._gather_batch_packed's batches pack to, the same pts,
pre-errors, events, SBC arrays and feed counts.  Each worker's pump
takes its share of the CPUs, max(1, CPUs // W), and no worker imports
torch or sees a card.  A tiny pooled cell (4 lanes, 2 workers, 2
titles, chunks of 2) run through the benchmark's own harness reads 0
on every check against espbench/reference/, and the control (the
reference's float32 IDCT in the program's place) reads > 0 on planes
and field checksums.  (The harness's refusal of a process that loaded
JAX is lifted there: this test process's conftest loads JAX.)
"""

import copy
import os
import socket
import threading

import numpy as np
import pytest
import torch

from espflix_tpu_torch.ops.host_pack import pack_slice_rows, row_perm
from espflix_tpu_torch.runtime import chunk_layout as CL
from espflix_tpu_torch.runtime import hostpool as HP
from espflix_tpu_torch.runtime import packed_gather as PG
from espflix_tpu_torch.runtime.events import Ev
from espflix_tpu_torch.runtime.hostpool import HostPool
from espflix_tpu_torch.runtime.player import PlayerSession
from espflix_tpu_torch.runtime.scheduler import Fleet
from espflix_tpu_torch.runtime.session import StreamFeed
from espflix_tpu_torch.streaming import native_pump as NP
from espflix_tpu_torch.streaming.streamer import Streamer
from espflix_tpu_torch.tools.indexer import make_service
from espflix_tpu_torch.tools.sbc_encode import random_frame

torch.set_num_threads(1)

W = 2                   # workers
F = 2                   # SBC frames a tick
TICKS = 3


def _lens(svc: str) -> list[int]:
    """Byte lengths of the pictures of a service's first title."""
    feed = StreamFeed()
    with open(f"{svc}/media/t/video.ts", "rb") as f:
        feed.feed(f.read())
    feed.eos()
    out = []
    while (p := feed.pop_picture()) is not None:
        out.append(len(p.payload))
    return out


@pytest.fixture(scope="module")
def services(tmp_path_factory):
    """(normal, big, words_per_lane): two one-title services; every
    picture of `normal` fits a lane of words_per_lane words, the first
    picture of `big` does not."""
    root = tmp_path_factory.mktemp("svc_pooled")
    rng = np.random.default_rng(4)
    audio = [(random_frame(rng, mode=0, bitpool=28), k * 240)
             for k in range(200)]
    normal, big = str(root / "normal"), str(root / "big")
    make_service(normal, ["t"], seed=3, n_gops=2, gop=4, audio_frames=audio)
    make_service(big, ["t"], seed=3, n_gops=2, gop=4, i_coeffs=24,
                 p_coeffs=24, audio_frames=audio)
    wpl = max(_lens(normal)) // 4 + 8
    assert _lens(big)[0] > 4 * (wpl - 4)
    return "file://" + normal, "file://" + big, wpl


def _start(call, lane, url):
    """Lane `lane` plays its title: from the file, or (lane 2) from a
    get_rom buffer of it."""
    call(lane, "nav", 0)
    call(lane, "play_pause")
    if lane == 2:
        call(lane, "play_rom", Streamer().get_url(url + "/media/t/video.ts"))


def _events(fleet):
    return [(int(e.ev), e.lane, e.value) for e in fleet.events.dump(10 ** 6)]


def _inprocess_inputs(b, audio, n, mb_h):
    """A tick's batch and SBC arrays packed per worker as a worker packs
    them, then joined as the pool joins its shards."""
    ln = n // W
    parts = []
    for k in range(W):
        sl_ = slice(k * ln, (k + 1) * ln)
        bk = {key: v[sl_] if isinstance(v, np.ndarray) else v
              for key, v in b.items()}
        sl = pack_slice_rows(bk, sort_rows=True, device_windows=True)
        perm, _dup = row_perm(sl["lane_of_row"], sl["rows"], sl["alive"],
                              ln, mb_h)
        parts.append(CL.tick_inputs(sl, perm, bk, {},
                                    [a[sl_] for a in audio]))
    return CL.join_workers(parts)


@pytest.fixture(scope="module")
def gathered(services):
    """Three ticks of the pool's gather beside the in-process fleet's,
    over the lanes normal, big, normal as ROM, normal."""
    normal, big, wpl = services
    urls = [normal, big, normal, normal]
    n = len(urls)
    f = Fleet(n, words_per_lane=wpl, parser="pallas", output=True,
              device="cpu", audio_frames_per_tick=F)
    for i, u in enumerate(urls):
        s = PlayerSession(u)
        assert s.init_service()
        f.attach(i, s)
        _start(lambda _lane, m, *a, s=s: getattr(s, m)(*a), i, u)
    ref = []
    for _ in range(TICKS):
        c0 = dict(f.counters)
        b, pts, pre = f._gather_batch_packed()
        audio = f._gather_audio_arrays(F)[:4]
        feed = {k: v - c0.get(k, 0) for k, v in f.counters.items()}
        ref.append((_inprocess_inputs(b, audio, n, f.mb_h), pts, pre,
                    b["active"], feed))
    with HostPool(n, W, wpl, f.mb_w, f.mb_h) as pool:
        assert pool.attach_many([0, 2, 3], normal) == [True] * 3
        assert pool.attach(1, big)
        for i, u in enumerate(urls):
            _start(pool.call, i, u)
        got = []
        assert pool.states() == ["PLAYING"] * n
        for _ in range(TICKS):
            got.append(pool.gather_tick(F))
        info = pool.info()
        procs = list(pool.procs)
    assert all(p.poll() is not None for p in procs)
    return ref, got, info, _events(f)


def test_worker_gather_matches_inprocess(gathered):
    ref, got, _info, events = gathered
    ev = []
    for (x, pts, pre, active, feed), g in zip(ref, got):
        assert set(x) == set(g) - {"pts", "pre_errors", "video", "n_i",
                                   "ev_pic", "ev_aud", "aud_op", "feed",
                                   "pool"}
        for k, v in x.items():
            assert np.array_equal(v, g[k]), k
        assert np.array_equal(pts, g["pts"])
        assert np.array_equal(pre, g["pre_errors"])
        assert np.array_equal(active, g["video"])
        assert feed == g["feed"]
        ev += g["ev_pic"] + g["ev_aud"]
    assert ev == events
    assert any(e[0] == int(Ev.LANE_OVERSIZE) and e[1] == 1
               for e in events)
    assert all(g["video"][[0, 2, 3]].all() for g in got)
    # the file:// lanes read from the title mappings, the ROM lane not
    feed = got[0]["feed"]
    assert 0 < feed["feed.mapped_bytes"] < feed["feed.bytes_read"]
    assert sum(g["pool"]["pool.ticks"] for g in got) == TICKS
    assert all(g["pool"]["pool.reply_bytes"] > 0 for g in got)


def test_workers_hold_no_torch_and_take_their_share_of_the_cpus(gathered):
    info = gathered[2]
    share = max(1, len(os.sched_getaffinity(0)) // W)
    assert len(info) == W
    for w in info:
        assert not w["torch"] and w["cuda_visible"] == ""
        assert w["pump_cpus"] == share


def test_packed_gather_caps_the_pump_at_its_cpus(services, monkeypatch):
    """The gather hands its CPU cap to the pump, which takes no more
    threads than that."""
    normal, _big, wpl = services
    seen = []
    run = NP.Pump.run

    def spy(self, pb, tm, slots, max_rounds, cpus=None):
        out = run(self, pb, tm, slots, max_rounds, cpus=cpus)
        seen.append((cpus, out.threads))
        return out
    monkeypatch.setattr(NP.Pump, "run", spy)
    monkeypatch.setattr(NP, "_threads", lambda n: 4)
    s = PlayerSession(normal)
    assert s.init_service()
    s.nav(0)
    s.play_pause()
    pg = PG.PackedGather(2, geometry=(352, 192), words_per_lane=wpl,
                         mb_w=22, mb_h=12, log=lambda *a, **k: None,
                         cpus=1)
    assert pg.gather([s, None]) is not None
    assert seen and all(c == 1 and t == 1 for c, t in seen)


def _reply(rng, lanes: int) -> tuple:
    """A gather reply's shape: arrays of several dtypes and widths, a
    strided view, an empty array, events and counts."""
    words = rng.integers(0, 2**32, (lanes, 97), dtype=np.uint32)
    return ("ok", dict(
        x=dict(lane_words=words, start_bits=words[:, ::3].astype(np.int32),
               alive=rng.random((lanes, 12)) < 0.5,
               aud_words=rng.integers(-2**15, 2**15, (lanes, 13, 16),
                                      dtype=np.int16),
               win=97),
        strided=words.T[::2], empty=np.zeros((0, 4), np.float64),
        pts=np.arange(lanes, dtype=np.int64) * 3000,
        ev_pic=[(3, 7, 1)], feed={"feed.bytes_read": 12}, gather_s=0.5))


def _same(a, b):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        assert np.array_equal(a, b) and b.flags.writeable
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("lanes", [1, 256, 4096])
def test_frames_carry_replies_whole(lanes):
    """Workers' gather replies, framed with their arrays out of band and
    read side by side from three sockets, read back equal and writable,
    frame after frame into each socket's reused buffer, also where a
    frame outgrows its socket's buffer; the byte counts are the
    frames'."""
    rng = np.random.default_rng(lanes)
    sent = [[_reply(rng, lanes), ("err", "ValueError: no"),
             _reply(rng, 2 * lanes)] for _ in range(3)]
    pairs = [socket.socketpair() for _ in sent]
    for _ours, theirs in pairs:
        theirs.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 1 << 16)
    writers = [threading.Thread(target=lambda t=theirs, ms=ms: [
        HP._send_frame(t.fileno(), m) for m in ms])
        for (_ours, theirs), ms in zip(pairs, sent)]
    for w in writers:
        w.start()
    socks = [ours for ours, _theirs in pairs]
    helds, sizes = [[bytearray()] for _ in socks], []
    try:
        for t in range(3):
            got = HP._recv_frames(socks, helds)
            for ms, (obj, _n) in zip(sent, got):
                _same(ms[t], obj)
            sizes.append([n for _obj, n in got])
        for w in writers:
            w.join(60)
            assert not w.is_alive()
        # every byte written was read, and counted
        for ours in socks:
            ours.setblocking(False)
            with pytest.raises(BlockingIOError):
                ours.recv(1)
    finally:
        for w in writers:
            w.join(60)
        for pair in pairs:
            for sk in pair:
                sk.close()
    for k, held in enumerate(helds):
        assert sizes[1][k] < sizes[0][k] < sizes[2][k]
        assert len(held[0]) < sizes[2][k] < len(held[0]) + 1024


def _tiny_pooled():
    from espbench.tests.tiny import tiny_cell
    cell = tiny_cell("ntsc.pooled")
    cell.cfg = copy.deepcopy(cell.cfg)
    cell.cfg["host"]["workers"] = W
    cell.mix = dict(cell.mix, lanes=4)
    return cell


@pytest.mark.parametrize("control", [False, True],
                         ids=["program", "control"])
def test_tiny_pooled_cell(control, monkeypatch):
    from espbench import run as R
    from espbench.tests.tiny import run_tiny

    # the harness refuses a process that has loaded JAX; this one's
    # conftest loads it for the JAX package's tests
    monkeypatch.setattr(R, "forbidden_modules", lambda: [])
    res = run_tiny(_tiny_pooled(), seed=2**31 + 11, control=control)
    checks = {k: c["value"] for k, c in res["checks"].items()}
    assert set(checks) == {"pts", "planes", "field_sum", "fields",
                           "flags", "audio_frames", "pdm", "pdm_sum",
                           "pdm_carry", "workers"}
    if control:
        assert not res["correct"]
        assert checks["planes"] > 0 and checks["field_sum"] > 0
    else:
        assert res["correct"] and res["failed"] == 0
        assert not any(checks.values()), checks
