"""The port's egress (runtime/egress.py, a copy) and serve_scenario
--egress against the JAX package.

The ring and the pump are the JAX package's code (pinned as a copy by
tests/test_torch_isolation.py); here they deliver the same bytes, in
order, with the same accounting as the original's.  Then
`serve_scenario --device cpu --stage full --egress 2 --egress-depth 8`
at 2 lanes and 8 ticks: the summary's "egress" block has the JAX tool's
keys, the byte accounting of tests/test_egress.py holds, and the
delivery checksum equals the JAX tool's on the same service and seed
(and the sum of the taps' field_sum + pdm_sum).
"""

import time

import numpy as np
import pytest
import torch

from espflix_tpu.runtime import egress as JE
from espflix_tpu_torch.runtime import egress as TE
from tests.torch_fleet import python_feed  # noqa: F401 - fixture

torch.set_num_threads(1)


@pytest.mark.parametrize("E", [JE, TE], ids=["jax", "port"])
def test_ring_bounded_and_fifo(E):
    r = E.EgressRing(depth=2)
    a = np.zeros((1, 2, 4, 8), np.uint8)
    p = np.zeros((1, 16), np.int32)
    for k in (1, 2, 3):
        r.push(a + k, p)       # the third evicts the oldest
    assert r.dropped == 1
    f, _ = r.pop()
    assert f[0, 0, 0, 0] == 2 and len(r) == 1


def _pump_run(E, n=12):
    got = []
    pump = E.EgressPump(tick_interval=0.004, depth=64,
                        sink=lambda f, p: got.append((f.copy(), p.copy())))
    pump.start()
    fields = np.arange(2 * 4 * 8, dtype=np.uint8).reshape(1, 2, 4, 8)
    pdm = np.arange(16, dtype=np.int32)[None]
    for k in range(n):
        pump.push(fields + k, pdm + k)
        time.sleep(0.002)
    st = pump.finish()
    return got, st


def test_pump_delivers_like_the_original():
    (gj, sj), (gt, st) = _pump_run(JE), _pump_run(TE)
    for s in (sj, st):
        assert s.pushed_ticks == s.consumed_ticks == 12
        assert s.dropped_ticks == 0
    assert (st.delivered_field_bytes, st.delivered_pdm_words) == \
        (sj.delivered_field_bytes, sj.delivered_pdm_words)
    assert len(gj) == len(gt)
    for (fa, pa), (fb, pb) in zip(gj, gt):
        assert np.array_equal(fa, fb) and np.array_equal(pa, pb)


def test_pump_checksum_and_underruns():
    pumps = []
    for E in (JE, TE):
        pump = E.EgressPump(tick_interval=0.004, depth=4)
        pump.start()
        pump.push(np.full((1, 2, 4, 8), 7, np.uint8),
                  np.full((1, 16), 70000, np.int32))
        # the consumer's own clock counts the underruns: wait for them
        # (a fixed sleep saw too few wakeups on a loaded machine)
        deadline = time.monotonic() + 30
        while pump.stats.underrun_ticks < 3 and time.monotonic() < deadline:
            time.sleep(0.004)
        pumps.append(pump.finish())
    sj, st = pumps
    assert st.checksum == sj.checksum == 7 * 64 + 70000 * 16
    assert st.consumed_ticks == 1 and st.underrun_ticks >= 3


def _scenario(SS, root, extra=()):
    return SS.main(["--lanes", "2", "--ticks", "8", "--titles", "1",
                    "--service", root, "--transport", "file",
                    "--stage", "full", "--egress", "2",
                    "--egress-depth", "8", *extra])


def test_scenario_egress_matches_jax(tmp_path, python_feed):  # noqa: F811
    from espflix_tpu.tools import serve_scenario as JSS
    from espflix_tpu_torch.tools import serve_scenario as TSS

    root = str(tmp_path / "svc")
    JSS.generate_service(root, ["one"], seed=3, n_gops=2, gop=4)
    pushed = []
    orig = TE.EgressPump.push

    def push(self, f, p):
        pushed.append((np.asarray(f).copy(), np.asarray(p).copy()))
        orig(self, f, p)
    TE.EgressPump.push = push
    try:
        out = _scenario(TSS, root, ["--device", "cpu"])
    finally:
        TE.EgressPump.push = orig
    ref = _scenario(JSS, root)
    eg, ej = out["egress"], ref["egress"]
    assert set(eg) == set(ej)
    assert eg["tapped_lanes"] == 2
    assert eg["pushed_ticks"] == out["full_ticks"] == ref["full_ticks"]
    assert eg["consumed_ticks"] + eg["dropped_ticks"] == eg["pushed_ticks"]
    assert eg["dropped_ticks"] == 0
    per_tick = 2 * 2 * 262 * 912          # tap x fields x L x W (NTSC)
    assert eg["delivered_field_bytes"] == eg["consumed_ticks"] * per_tick
    assert eg["delivered_pdm_words"] == ej["delivered_pdm_words"] > 0
    assert eg["checksum"] == ej["checksum"]
    want = sum(int(f.astype(np.int64).sum()) + int(p.astype(np.int64).sum())
               for f, p in pushed) & 0x7FFFFFFF
    assert len(pushed) == eg["pushed_ticks"] and eg["checksum"] == want


def test_egress_requires_the_full_stage():
    from espflix_tpu_torch.tools import serve_scenario as TSS
    with pytest.raises(ValueError):
        TSS.main(["--stage", "decode", "--egress", "2", "--device", "cpu"])
