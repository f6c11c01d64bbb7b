"""serve_scenario --stage decode: the port vs the JAX tool.

run_scenario on three lanes, 8 ticks, two injected corrupt pictures and
a snapshot at tick 4, for each decode-only dispatch ("pipelined":
tick_submit / tick_collect; "chunk": run_chunk in chunks of 4): the JAX
tool's fleet on the Pallas parser (interpret mode, as the JAX tests run
it) and the port's build_fleet(device="cpu") give the same
ScenarioStats, snapshot, sessions and event log.  The JAX tool's own
--stage decode default is its 'device' parser; test_runtime_extra pins
that the two parsers present the same frames on clean streams.
"""

import numpy as np
import pytest
import torch

from espflix_tpu.tools import serve_scenario as JSS
from espflix_tpu_torch.tools import serve_scenario as TSS
from tests.torch_fleet import make_service, python_feed, session_view

torch.set_num_threads(1)

DISPATCHES = ("pipelined", "chunk")
STAT_KEYS = ("frames", "audio_lanes", "errors", "resyncs", "actions",
             "ticks", "lanes", "full_ticks", "tap_field_bytes")


@pytest.fixture(scope="module")
def scenarios(tmp_path_factory, python_feed):
    url = make_service(tmp_path_factory, "svc_serve_decode")
    out = {}
    for d in DISPATCHES:
        jf = JSS.build_fleet(url, 3, 2, words_per_lane=8192)
        jf.parser = "pallas"
        jf._pallas_interpret = True
        tf = TSS.build_fleet(url, 3, 2, device="cpu")
        kw = dict(seed=3, faults=2, snapshot_at=4, dispatch=d)
        out[d] = (jf, JSS.run_scenario(jf, 8, **kw), tf,
                  TSS.run_scenario(tf, 8, **kw))
    return out


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("key", STAT_KEYS)
def test_scenario_stats_match(scenarios, dispatch, key):
    _jf, (js, _jsnap), _tf, (ts, _tsnap) = scenarios[dispatch]
    assert getattr(ts, key) == getattr(js, key)


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_scenario_state_matches(scenarios, dispatch):
    """Per-lane frames, the snapshot, the sessions and the events."""
    jf, (js, jsnap), tf, (ts, tsnap) = scenarios[dispatch]
    assert np.array_equal(ts.frames_per_lane, js.frames_per_lane)
    assert tsnap == jsnap and tsnap is not None
    assert [session_view(s) for s in tf.sessions] == \
        [session_view(s) for s in jf.sessions]
    assert [(e.ev, e.lane, e.value) for e in tf.events.dump(10 ** 6)] == \
        [(e.ev, e.lane, e.value) for e in jf.events.dump(10 ** 6)]
    assert ts.errors >= 1 and ts.resyncs >= 1 and ts.frames >= 8
