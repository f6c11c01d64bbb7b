"""The decode-only fleet's tick: the port vs the JAX package.

A JAX Fleet(parser="pallas") on the CPU (Pallas in interpret mode) and
the port's Fleet(output=False, device="cpu") serve the same file://
service (2 titles, 2 GOPs of 6) on the Python session feed from the
same random frames, parity and SBC history, tick by tick with audio:

  * one lane, 6 ticks -- every tick takes the small-fleet branch of
    decode_picture_batch_sliced (the uniform-budget lane-minor scan and
    dense phase, K1F -> K2F -> K3F);
  * four lanes with three sessions, the first picture of lane 1 the
    corrupt one of serve_scenario, 6 ticks -- the two-bucket dense
    branch (K1 -> K2 -> K3) with the error contained and resynced.

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

TICKS = 6
SCENARIOS = {
    # name: (lanes, attached lanes, corrupt lane)
    "one_lane": (1, (0,), None),
    "four_lanes": (4, (0, 1, 3), 1),
}


@pytest.fixture(scope="module")
def ticked(tmp_path_factory, python_feed):
    url = make_service(tmp_path_factory, "svc_decode")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, (n, lanes, bad) in SCENARIOS.items():
            calls = {"run_scan_bucketed": 0, "run_scan_bucketed_dense": 0}
            for fn in calls:
                def counted(*a, _f=getattr(TVS, fn), _k=fn, **k):
                    calls[_k] += 1
                    return _f(*a, **k)
                mp.setattr(TVS, fn, counted)
            out[name] = run_both(
                url, lambda f: [f.tick() for _ in range(TICKS)], n=n,
                lanes=lanes, corrupt_lane=bad, seed=len(name)) + (calls,)
            mp.undo()
    return out


@pytest.mark.parametrize("scenario", list(SCENARIOS))
@pytest.mark.parametrize("key", RESULT_KEYS)
def test_tick_results_match(ticked, scenario, key):
    _jf, jr, _tf, tr, _calls = ticked[scenario]
    assert_results_equal(jr, tr, key)


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_tick_carries_match(ticked, scenario):
    jf, _jr, tf, _tr, _calls = ticked[scenario]
    assert_carries_equal(jf, tf)


def test_ticks_exercise_both_branches(ticked):
    """One lane runs the lane-minor scan every tick; four lanes with
    three sessions run the dense scan; the corrupt picture errors lane
    1 once and it resyncs; audio decoded; every lane presented."""
    _jf, r1, _tf, _tr, c1 = ticked["one_lane"]
    assert c1 == {"run_scan_bucketed": TICKS, "run_scan_bucketed_dense": 0}
    _jf, _jr, tf, r4, c4 = ticked["four_lanes"]
    assert c4["run_scan_bucketed_dense"] >= 1
    errs = np.stack([r.errors for r in r4])
    assert errs[:, 1].sum() == 1 and not errs[:, [0, 2, 3]].any()
    names = [e.ev.name for e in tf.events.dump(10 ** 6)]
    assert "LANE_ERROR" in names and "LANE_RESYNC" in names
    vl = np.stack([r.video_lanes for r in r4])
    assert vl[:, [0, 1, 3]].any(axis=0).all() and not vl[:, 2].any()
    assert all(np.stack([r.audio_lanes for r in r4])[:, [0, 1, 3]]
               .any(axis=0))
    assert all(r.video_lanes[0] for r in r1)
    assert isinstance(r1[0].y, np.ndarray)
