"""The port's geometry router (runtime/router.py, a copy) against JAX.

A 352x240 title parks in a 352x192 fleet of each package with a
LANE_GEOMETRY event; each package's FleetRouter re-homes it to a fleet
of its geometry (the port's on the CPU: the decode-only tick with the
slice-scan parser at mb_height 15), where it decodes: 6 ticks with the
same presented lanes, pts, error flags and Y/U/V planes as the JAX
fleet's.  The rejection path (a geometry beyond max_fleets stays out)
is the same too.
"""

import numpy as np
import torch

from tests.torch_fleet import python_feed  # noqa: F401 - fixture

torch.set_num_threads(1)


def _parked(pkg, svc, **kw):
    import importlib
    P = importlib.import_module(f"{pkg}.runtime.player")
    S = importlib.import_module(f"{pkg}.runtime.scheduler")
    E = importlib.import_module(f"{pkg}.runtime.events")
    s = P.PlayerSession("file://" + svc)
    assert s.init_service()
    s.nav(0)
    s.play_pause()
    fleet = S.Fleet(1, words_per_lane=8192, **kw)      # 352x192
    fleet.attach(0, s)
    r = fleet.tick(decode_audio=False)
    assert r.errors[0]
    assert E.Ev.LANE_GEOMETRY in [e.ev for e in fleet.events.dump(10 ** 6)]
    assert s.park_geometry == (352, 240)
    return fleet, s


def test_router_rehomes_and_decodes_like_jax(tmp_path,
                                             python_feed):  # noqa: F811
    from espflix_tpu.runtime.router import FleetRouter as JRouter
    from espflix_tpu.tools.indexer import make_service
    from espflix_tpu_torch.runtime.router import FleetRouter as TRouter

    svc = str(tmp_path / "svc240")
    make_service(svc, ["tall"], seed=13, n_gops=2, gop=4, width=352,
                 height=240)
    runs = []
    for pkg, Router, kw in (("espflix_tpu", JRouter, {}),
                            ("espflix_tpu_torch", TRouter,
                             {"device": "cpu"})):
        fleet, s = _parked(pkg, svc, **kw)
        router = Router(fleet, lanes_per_fleet=1,
                        fleet_kwargs=dict(words_per_lane=8192, **kw))
        assert router.route() == 1
        assert fleet.sessions[0] is None
        tall = router.fleets[(352, 240)]
        assert tall.sessions[0] is s and (tall.mb_w, tall.mb_h) == (22, 15)
        runs.append([tall.tick(decode_audio=False) for _ in range(6)])
    frames = 0
    for rj, rt in zip(*runs):
        assert np.array_equal(rj.video_lanes, rt.video_lanes)
        assert np.array_equal(rj.pts, rt.pts)
        assert np.array_equal(rj.errors, rt.errors) and not rt.errors[0]
        if rt.video_lanes[0]:
            frames += 1
            for k in "yuv":
                assert np.array_equal(np.asarray(getattr(rj, k)),
                                      getattr(rt, k)), k
    assert frames >= 3, "re-homed lane never decoded"


def test_router_rejects_past_max_fleets(tmp_path, python_feed):  # noqa: F811
    from espflix_tpu.tools.indexer import make_service
    from espflix_tpu_torch.runtime.router import FleetRouter

    svc = str(tmp_path / "svc240")
    make_service(svc, ["tall"], seed=13, n_gops=1, gop=2, width=352,
                 height=240)
    fleet, s = _parked("espflix_tpu_torch", svc, device="cpu")
    router = FleetRouter(fleet, max_fleets=1, fleet_kwargs=dict(device="cpu"))
    assert router.route() == 0
    assert router.rejected == [(0, (352, 240))]
    assert s.park_geometry is None and fleet.sessions[0] is s
    assert set(router.tick_all(decode_audio=False)) == {(352, 192)}
