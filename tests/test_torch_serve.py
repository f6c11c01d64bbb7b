"""The serving path: the port's host copies and Fleet.run_chunk_full vs JAX.

Host copies pinned to their originals: on the same TS bytes the port's
StreamFeed pops the same pictures and SBC frames; PlayerSession gives
the same states and snapshots after the same action script; the
OutputStage's tick_state sequence over a beep, a progress update and a
slide in each direction; bucket_policy on a grid.

Serving parity: the JAX Fleet(parser="pallas", output=True) on the CPU
(Pallas in interpret mode) and the port's Fleet(device="cpu") serve the
same file:// service (2 titles, 2 GOPs of 6) on 4 lanes for 2 chunks of
K=4 ticks, with the same control actions, one injected corrupt picture
and two lanes mid-slide (the scrolled chain), both on the Python session
feed (ESPFLIX_NATIVE_FEED=0).  Every TickResult field and the final
frames, SBC history and PDM state are equal.
"""

import numpy as np
import pytest
import torch

import jax

from espflix_tpu.runtime import output as JOUT
from espflix_tpu.runtime import player as JPL
from espflix_tpu.runtime import scheduler as JSCH
from espflix_tpu.runtime import session as JSES
from espflix_tpu.tools import serve_scenario as JSS
from espflix_tpu_torch.runtime import output as TOUT
from espflix_tpu_torch.runtime import player as TPL
from espflix_tpu_torch.runtime import scheduler as TSCH
from espflix_tpu_torch.runtime import session as TSES
from espflix_tpu_torch.tools import serve_scenario as TSS

torch.set_num_threads(1)

LANES, K, CHUNKS = 4, 4, 2


@pytest.fixture(scope="module")
def service(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("svc_torch"))
    TSS.generate_service(root, ["one", "two"], seed=7, n_gops=2, gop=6)
    return root


@pytest.fixture(scope="module")
def python_feed():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ESPFLIX_NATIVE_FEED", "0")
        yield


def _pic_key(p):
    return (p.pic_type, p.full_pel, p.r_size, p.payload,
            list(p.slice_offsets), list(p.slice_rows), p.pts,
            p.seq.width, p.seq.height, p.seq.intra_q.tolist(),
            p.seq.non_intra_q.tolist())


@pytest.mark.parametrize("chunk", [188 * 7 + 5, 8 * 188 * 4])
def test_stream_feed_matches(service, chunk):
    """Same TS bytes in uneven reads: the same pictures (payload, pts,
    type, slices, sequence) and the same SBC frames out."""
    with open(f"{service}/media/one/video.ts", "rb") as f:
        ts = f.read()
    jf, tf = JSES.StreamFeed(), TSES.StreamFeed()
    n_pics = 0
    for off in range(0, len(ts), chunk):
        for feed in (jf, tf):
            feed.feed(ts[off:off + chunk])
        while True:
            a, b = jf.pop_picture(), tf.pop_picture()
            assert (a is None) == (b is None)
            if a is None:
                break
            assert _pic_key(a) == _pic_key(b)
            n_pics += 1
        assert jf.audio.discover(JSCH.Fleet._sbc_probe) == \
            tf.audio.discover(TSCH.Fleet._sbc_probe)
        fa, fb = jf.audio.pop_frames_array(3), tf.audio.pop_frames_array(3)
        assert (fa is None) == (fb is None)
        if fa is not None:
            assert np.array_equal(fa, fb)
    for feed in (jf, tf):
        feed.eos()
    while (a := jf.pop_picture()) is not None:
        assert _pic_key(a) == _pic_key(tf.pop_picture())
        n_pics += 1
    assert tf.pop_picture() is None
    assert n_pics == 12 and jf.audio.frame_size == tf.audio.frame_size
    assert jf.audio.buf == tf.audio.buf and not tf.sync_lost


def _session_view(s):
    return (s.state.name, s.speed, s.nav_index, s.last_pts, s.eos,
            s.snapshot(), {i: t.pos for i, t in s.info.items()})


def test_player_session_matches(service, python_feed):
    """The same action script on a JAX and a port PlayerSession: the
    same pictures, states, positions and snapshots after every step,
    and the same restore into fresh sessions."""
    url = "file://" + service
    js, ts = JPL.PlayerSession(url), TPL.PlayerSession(url)
    assert js.init_service() and ts.init_service()
    script = [("nav", 1), ("play_pause",), ("pics", 5), ("fast_forward",),
              ("pics", 3), ("play_pause",), ("pics", 2), ("skip", 30),
              ("pics", 4), ("play_pause",), ("pics", 1), ("play_pause",),
              ("rewind",), ("pics", 2), ("menu",), ("nav", 0),
              ("play_pause",), ("skip", -30), ("pics", 40)]
    for step in script:
        for s in (js, ts):
            if step[0] != "pics":
                getattr(s, step[0])(*step[1:])
        if step[0] == "pics":
            for _ in range(step[1]):
                a, b = js.next_picture(), ts.next_picture()
                assert (a is None) == (b is None)
                if a is not None:
                    assert _pic_key(a) == _pic_key(b)
                    js.on_presented(a.pts)
                    ts.on_presented(b.pts)
        assert _session_view(js) == _session_view(ts), step
    assert ts.state.name == "DONE"
    snap = ts.snapshot()
    assert snap == js.snapshot()
    j2, t2 = JPL.PlayerSession(url), TPL.PlayerSession(url)
    assert j2.init_service() and t2.init_service()
    assert j2.restore(snap) == t2.restore(snap)
    assert _session_view(j2) == _session_view(t2)


def test_output_tick_state_matches():
    """tick_state over a beep, a progress update and a slide in each
    direction (with the same outgoing planes) equals the JAX stage's."""
    n = 4
    rng = np.random.default_rng(5)
    prev = (rng.integers(0, 256, (n, 192, 352), dtype=np.uint8),
            rng.integers(0, 256, (n, 96, 176), dtype=np.uint8),
            rng.integers(0, 256, (n, 96, 176), dtype=np.uint8))
    jo, to = JOUT.OutputStage(n), TOUT.OutputStage(n)
    assert np.array_equal(to.pdm_state.numpy(), np.asarray(jo.pdm_state))
    for t in range(14):
        for o in (jo, to):
            if t == 0:
                o.beep(1)
                o.show_progress(0)
                o.start_slide(2, 2, prev=prev)
            if t == 1:
                o.update_progress(0, 95 * 90000 + 7, 600 * 90000,
                                  o.icon_for(1, False))
            if t == 3:
                o.start_slide(3, 3, prev=prev)
                o.beep(0)
            if t == 5:
                o.hide_progress(0)
        a, b = jo.tick_state(13), to.tick_state(13)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), \
                (t, k)
    for a, b in zip(jo.slide_planes(), to.slide_planes()):
        assert np.array_equal(a, b)
    assert TOUT.OutputStage.icon_for(-1, False) == \
        JOUT.OutputStage.icon_for(-1, False)


def test_bucket_policy_matches():
    for ns in (8, 48, 100, 3072, 12288):
        for need in (0, 1, 8, 9, 24, 47, 64, 1000, 3072, 6000, 12288):
            for floor in (1, 8):
                kw = dict(steps_long=1024, steps_short=384, floor=floor)
                assert TSCH.bucket_policy(need, ns, **kw) == \
                    JSCH.bucket_policy(need, ns, **kw), (need, ns, floor)


# ---- serving parity --------------------------------------------------

RESULT_KEYS = ("video_lanes", "pts", "errors", "audio_lanes",
               "audio_starved", "audio_errors", "field_sum", "pdm_sum",
               "tap_fields", "tap_pdm", "y", "u", "v")
TAP = (0, 2)


def _serve(fleet, PL, SS, url, prev):
    """Attach 4 sessions and run 2 chunks of K ticks with one corrupt
    picture, two lanes mid-slide and a control action between chunks;
    returns the TickResults."""
    for i in range(LANES):
        s = PL.PlayerSession(url)
        assert s.init_service()
        s.nav(i % 2)
        s.play_pause()
        fleet.attach(i, s)
    # lane 1's first picture is the corrupt one (contained + resynced)
    s1 = fleet.sessions[1]
    orig = s1.next_picture
    bad = SS.corrupt_picture()
    fired = []

    def tampered():
        p = orig()
        if p is not None and not fired:
            fired.append(1)
            bad.pts = p.pts
            return bad
        return p
    s1.next_picture = tampered
    out = fleet.output
    out.start_slide(2, 2, prev=prev)
    out.start_slide(0, 3, prev=prev)
    out.beep(3)
    out.show_progress(0)
    results = []
    for c in range(CHUNKS):
        if c:
            fleet.sessions[3].skip(30)
            fleet.sessions[0].play_pause()          # pause
            out.beep(1)
        results += fleet.run_chunk_full(K, tap_lanes=TAP)
    return results


@pytest.fixture(scope="module")
def served(service, python_feed):
    url = "file://" + service
    rng = np.random.default_rng(11)
    prev = (rng.integers(0, 256, (LANES, 192, 352), dtype=np.uint8),
            rng.integers(0, 256, (LANES, 96, 176), dtype=np.uint8),
            rng.integers(0, 256, (LANES, 96, 176), dtype=np.uint8))
    jf = JSCH.Fleet(LANES, words_per_lane=8192, parser="pallas",
                    output=True)
    jr = _serve(jf, JPL, JSS, url, prev)
    tf = TSCH.Fleet(LANES, words_per_lane=8192, device="cpu")
    # record whether each of the port's chain calls ran scrolled
    chain_forward = tf.chain.forward

    def forward(*a, **kw):
        tf.scrolled_calls.append(kw["scrolled"])
        return chain_forward(*a, **kw)
    tf.scrolled_calls = []
    tf.chain.forward = forward
    tr = _serve(tf, TPL, TSS, url, prev)
    return jf, jr, tf, tr


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("key", RESULT_KEYS)
def test_tick_results_match(served, key):
    _jf, jr, _tf, tr = served
    assert len(jr) == len(tr) == K * CHUNKS
    for t, (a, b) in enumerate(zip(jr, tr)):
        x, y = _np(getattr(a, key)), _np(getattr(b, key))
        assert x.dtype == y.dtype and x.shape == y.shape, (t, key)
        assert np.array_equal(x, y), (t, key)


def test_final_carries_match(served):
    jf, _jr, tf, _tr = served
    for k in ("y", "u", "v", "parity"):
        assert np.array_equal(np.asarray(jf.frames[k]),
                              tf.frames[k].numpy()), k
    assert np.array_equal(np.asarray(jf.sbc_state), tf.sbc_state.numpy())
    assert np.array_equal(np.asarray(jf.output.pdm_state),
                          tf.output.pdm_state.numpy())
    assert [_session_view(s) for s in jf.sessions] == \
        [_session_view(s) for s in tf.sessions]
    assert [(e.ev, e.lane, e.value) for e in jf.events.dump(10 ** 6)] == \
        [(e.ev, e.lane, e.value) for e in tf.events.dump(10 ** 6)]


def test_serving_run_exercises_the_path(served):
    """Not a degenerate run: the corrupt picture was caught and the lane
    resynced, lanes slid (scrolled chain), beeped and decoded audio,
    and a paused lane stopped presenting."""
    _jf, _jr, tf, tr = served
    errs = np.stack([r.errors for r in tr])
    assert errs[:, 1].any() and not errs[:, [0, 2, 3]].any()
    names = [e.ev.name for e in tf.events.dump(10 ** 6)]
    assert "LANE_ERROR" in names and "LANE_RESYNC" in names
    assert all(np.stack([r.audio_lanes for r in tr]).any(axis=0))
    vl = np.stack([r.video_lanes for r in tr])
    assert vl[:K].all() and not vl[K:, 0].any()
    assert tf.scrolled_calls == [True, True]
    assert tf.output.animate_index.tolist() == [0, 0, 0, 0]
    assert jax.default_backend() == "cpu"
