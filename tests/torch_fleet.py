"""Helpers of the decode-only fleet parity tests (test_torch_decode*.py,
test_torch_device_parser.py, test_torch_mesh_*fleet.py): one script
drives a JAX Fleet and the port's Fleet(output=False, device="cpu") on
the same parser (and mesh) and file:// service, from the same lived-in
start state, and every TickResult field, the final frames, parity and
SBC history, the sessions and the event logs are compared."""

import numpy as np
import pytest
import torch

from espflix_tpu.runtime import player as JPL
from espflix_tpu.runtime import scheduler as JSCH
from espflix_tpu.tools import serve_scenario as JSS
from espflix_tpu_torch.parallel import mesh as TPM
from espflix_tpu_torch.runtime import chain as TCH
from espflix_tpu_torch.runtime import player as TPL
from espflix_tpu_torch.runtime import scheduler as TSCH
from espflix_tpu_torch.tools import serve_scenario as TSS

RESULT_KEYS = ("video_lanes", "y", "u", "v", "pts", "errors",
               "audio_lanes", "pcm", "pcm_samples", "audio_starved",
               "audio_errors")


def make_service(tmp_path_factory, name):
    root = str(tmp_path_factory.mktemp(name))
    TSS.generate_service(root, ["one", "two"], seed=7, n_gops=2, gop=6)
    return "file://" + root


def np_(a):
    if a is None:
        return None
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def session_view(s):
    return None if s is None else (
        s.state.name, s.speed, s.nav_index, s.last_pts, s.eos,
        s.snapshot(), {i: t.pos for i, t in s.info.items()})


def _fleets(url, n, lanes, corrupt_lane, seed, parser="pallas", shards=0):
    """(jax fleet, port fleet) on `parser`: sessions on `lanes` (title
    lane % 2), the first picture of `corrupt_lane` replaced by
    serve_scenario.corrupt_picture(), and the same random frames,
    parity and SBC history in both.  shards > 0 puts both fleets on a
    'streams' mesh of that many devices (the JAX package's first
    virtual CPU devices; the port's [cpu] * shards)."""
    jmesh = tmesh = None
    if shards:
        from espflix_tpu.parallel import mesh as JPM
        jmesh = JPM.make_mesh(shards)
        tmesh = TPM.make_mesh(devices=[torch.device("cpu")] * shards)
    jf = JSCH.Fleet(n, words_per_lane=8192, parser=parser, mesh=jmesh)
    tf = TSCH.Fleet(n, words_per_lane=8192, output=False, device="cpu",
                    parser=parser, mesh=tmesh)
    for fleet, PL, SS in ((jf, JPL, JSS), (tf, TPL, TSS)):
        for i in lanes:
            s = PL.PlayerSession(url)
            assert s.init_service()
            s.nav(i % 2)
            s.play_pause()
            fleet.attach(i, s)
        if corrupt_lane is not None:
            s = fleet.sessions[corrupt_lane]
            orig, bad, fired = s.next_picture, SS.corrupt_picture(), []

            def tampered(orig=orig, bad=bad, fired=fired):
                p = orig()
                if p is not None and not fired:
                    fired.append(1)
                    bad.pts = p.pts
                    return bad
                return p
            s.next_picture = tampered
    rng = np.random.default_rng(seed)
    frames = {k: rng.integers(0, 249, np.asarray(jf.frames[k]).shape,
                              dtype=np.uint8) for k in "yuv"}
    frames["parity"] = rng.integers(0, 2, n).astype(np.int32)
    sbc = rng.integers(-30000, 30000, np.asarray(jf.sbc_state).shape
                       ).astype(np.int32)
    import jax.numpy as jnp
    jf.frames = {k: jnp.asarray(v) for k, v in frames.items()}
    jf.sbc_state = jnp.asarray(sbc)
    tf.frames, tf.sbc_state, _ = TCH.state_from_numpy(frames, sbc, None,
                                                      "cpu")
    if shards:
        jf.frames = JPM.shard_lane_tree(jmesh, jf.frames)
        tf.frames = TPM.shard_lane_tree(tmesh, tf.frames)
    return jf, tf


def run_both(url, script, *, n, lanes, corrupt_lane=None, seed=0,
             parser="pallas", shards=0):
    """script(fleet) -> list of TickResults, run on both fleets.
    Returns (jf, jax results, tf, port results)."""
    jf, tf = _fleets(url, n, lanes, corrupt_lane, seed, parser, shards)
    return jf, script(jf), tf, script(tf)


def ticks_then_chunk(fleet):
    """Two ticks, then a run_chunk of two."""
    return [fleet.tick(), fleet.tick()] + fleet.run_chunk(2)


def assert_results_equal(jr, tr, key):
    assert len(jr) == len(tr) > 0
    for t, (a, b) in enumerate(zip(jr, tr)):
        x, y = np_(getattr(a, key)), np_(getattr(b, key))
        if x is None or y is None:
            assert x is None and y is None, (t, key)
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, (t, key)
        assert np.array_equal(x, y), (t, key)


def assert_carries_equal(jf, tf):
    frames = tf.frames
    if tf.mesh is not None:
        frames = TPM.unshard_tree(tf.mesh, frames)
    fr, sbc, _ = TCH.state_to_numpy(frames, tf.sbc_state, None)
    for k in ("y", "u", "v", "parity"):
        a, b = fr[k], np.asarray(jf.frames[k])
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert np.array_equal(sbc, np.asarray(jf.sbc_state))
    assert [session_view(s) for s in jf.sessions] == \
        [session_view(s) for s in tf.sessions]
    assert [(e.ev, e.lane, e.value) for e in jf.events.dump(10 ** 6)] == \
        [(e.ev, e.lane, e.value) for e in tf.events.dump(10 ** 6)]


@pytest.fixture(scope="module")
def python_feed():
    """Both packages' sessions on the Python stream feed."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ESPFLIX_NATIVE_FEED", "0")
        yield
