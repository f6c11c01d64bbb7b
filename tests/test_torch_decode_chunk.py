"""The decode-only fleet's pipelined and chunked dispatch: port vs JAX.

As tests/test_torch_decode.py (same service, Python session feed, same
lived-in start state), on three lanes:

  * run_pipelined, 6 ticks with planes left on the device
    (fetch_frames=False: the port hands back tensors);
  * run_chunk, two chunks of K = 4 ticks -- the lane-minor scan in two
    budget buckets and the lane-minor dense phase (K1F -> K2F -> K3F),
    one host sync per chunk -- with the first picture of lane 2 the
    corrupt one and a 30 s skip and a pause between the chunks.

Every TickResult field, the final frames, parity, SBC history, the
sessions and the event logs are equal.
"""

import numpy as np
import pytest
import torch

from espflix_tpu_torch.ops import vlc_scan as TVS
from tests.torch_fleet import (RESULT_KEYS, assert_carries_equal,
                               assert_results_equal, make_service,
                               python_feed, run_both)

torch.set_num_threads(1)

K = 4


def _pipelined(fleet):
    return fleet.run_pipelined(6, fetch_frames=False)


def _chunked(fleet):
    rs = fleet.run_chunk(K)
    fleet.sessions[0].skip(30)
    fleet.sessions[1].play_pause()                    # pause
    return rs + fleet.run_chunk(K)


SCENARIOS = {"run_pipelined": (_pipelined, None),
             "run_chunk": (_chunked, 2)}


@pytest.fixture(scope="module")
def dispatched(tmp_path_factory, python_feed):
    url = make_service(tmp_path_factory, "svc_decode_chunk")
    out = {}
    for name, (script, bad) in SCENARIOS.items():
        out[name] = run_both(url, script, n=3, lanes=(0, 1, 2),
                             corrupt_lane=bad, seed=len(name))
    return out


@pytest.mark.parametrize("scenario", list(SCENARIOS))
@pytest.mark.parametrize("key", RESULT_KEYS)
def test_dispatch_results_match(dispatched, scenario, key):
    _jf, jr, _tf, tr = dispatched[scenario]
    assert_results_equal(jr, tr, key)


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_dispatch_carries_match(dispatched, scenario):
    jf, _jr, tf, _tr = dispatched[scenario]
    assert_carries_equal(jf, tf)


def test_dispatch_exercises_the_path(dispatched):
    """Pipelined planes stay tensors; the chunk caught the corrupt
    picture on lane 2 only and resynced it; the paused lane stopped
    presenting in the second chunk; audio decoded."""
    _jf, _jr, _tf, rp = dispatched["run_pipelined"]
    assert isinstance(rp[0].y, torch.Tensor)
    assert np.stack([r.video_lanes for r in rp]).all()
    _jf, _jr, tf, rc = dispatched["run_chunk"]
    assert len(rc) == 2 * K
    errs = np.stack([r.errors for r in rc])
    assert errs[:, 2].sum() == 1 and not errs[:, :2].any()
    names = [e.ev.name for e in tf.events.dump(10 ** 6)]
    assert names.count("LANE_RESYNC") == 1
    vl = np.stack([r.video_lanes for r in rc])
    assert vl[:K].all() and not vl[K:, 1].any() and vl[K:, 0].all()
    assert np.stack([r.audio_lanes for r in rc]).any(axis=0).all()
    assert TVS.launches_flat == 0          # the CPU never launches K1F
