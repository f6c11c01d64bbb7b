"""The port's host worker pool (runtime/hostpool.py) and
Fleet.run_chunk_full_pooled on the CPU.

Two lanes on two worker processes, three ticks: every TickResult field
the pooled chain returns (video lanes, pts, error flags, checksums, the
tapped lane's fields and PDM words, audio flags, and the presented
planes it keeps on the device) equals in-process run_chunk_full on the
same service, as tests/test_hostpool.py holds the JAX package's pool,
and every field but the planes equals the JAX package's own HostPool +
Fleet.run_chunk_full_pooled on that service (whose pooled path returns
no planes);
snapshot/restore round-trips through the pool; each worker runs with
CUDA_VISIBLE_DEVICES="" and never imports torch; and close() leaves no
worker running.  Lanes whose pictures the fleet must reject -- a
picture one to three bytes past what a lane holds, a picture with more
slices than MB rows -- are dropped and re-seeked in the workers as in
process, with the same results and the same events.  On a card
(gpu-marked) the pooled chain on CUDA equals in-process run_chunk_full
on CUDA, and only the test's own process holds a CUDA context while the
workers run.
"""

import dataclasses
import subprocess

import numpy as np
import pytest
import torch

from espflix_tpu_torch.runtime.hostpool import HostPool
from espflix_tpu_torch.runtime.player import PlayerSession
from espflix_tpu_torch.runtime.scheduler import Fleet, TickResult
from espflix_tpu_torch.runtime.session import StreamFeed
from espflix_tpu_torch.tools import indexer
from espflix_tpu_torch.tools.indexer import make_service
from espflix_tpu_torch.tools.sbc_encode import random_frame

torch.set_num_threads(1)

KEYS = ("video_lanes", "pts", "errors", "field_sum", "pdm_sum",
        "tap_fields", "tap_pdm", "audio_lanes", "audio_errors",
        "audio_starved", "y", "u", "v")


@pytest.fixture(scope="module")
def service(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("svcpool_t"))
    rng = np.random.default_rng(9)
    audio = [(random_frame(rng, mode=0, bitpool=28), k * 240)
             for k in range(200)]
    make_service(d, ["one"], seed=9, n_gops=3, gop=4, audio_frames=audio)
    return "file://" + d


def _compute_app_pids():
    return sorted(subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.split())


def _assert_results_equal(ref, got, keys=KEYS):
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        for k in keys:
            x, y = getattr(a, k), getattr(b, k)
            if x is None or y is None:
                assert x is None and y is None, k
            else:
                assert np.array_equal(_host(x), _host(y)), k


def _host(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _events(fleet):
    return [(e.ev.name, e.lane, e.value)
            for e in fleet.events.dump(10 ** 6)]


def _pooled_against_inprocess(service, device):
    n = 2
    f1 = Fleet(n, words_per_lane=8192, parser="pallas", output=True,
               device=device)
    for i in range(n):
        s = PlayerSession(service)
        assert s.init_service()
        s.nav(0)
        s.play_pause()
        f1.attach(i, s)
    ref = f1.run_chunk_full(3, tap_lanes=(0,))

    f2 = Fleet(n, words_per_lane=8192, parser="pallas", output=True,
               device=device)
    before = _compute_app_pids() if device == "cuda" else None
    with HostPool(n, 2, 8192, f2.mb_w, f2.mb_h) as pool:
        for w in pool.workers:
            assert w["cuda_visible"] == "" and not w["torch"]
        for i in range(n):
            assert pool.attach(i, service)
            pool.call(i, "nav", 0)
            pool.call(i, "play_pause")
            assert pool.state(i) == "PLAYING"
        got = f2.run_chunk_full_pooled(pool, 3, tap_lanes=(0,))
        assert len(got) == 3
        _assert_results_equal(ref, got)
        assert _events(f2) == _events(f1)
        assert all(r.video_lanes.all() for r in got)
        assert not any(r.errors.any() for r in got)
        # the workers ran sessions and still hold no torch
        assert not any(w["torch"] for w in pool.info())
        snaps = pool.snapshot()
        assert len(snaps) == n and all(s is not None for s in snaps)
        assert pool.restore(snaps) == n
        procs = list(pool.procs)
        if device == "cuda":
            # the contexts before the pool, and no worker's (nvidia-smi
            # may name pids of another pid namespace than ours)
            workers = {w["pid"] for w in pool.workers}
            smi = _compute_app_pids()
            assert smi == before and not workers & {int(x) for x in smi}
    assert all(p.poll() is not None for p in procs)
    return got


@pytest.fixture(scope="module")
def cpu_pooled(service):
    """The port's pooled results on the CPU, held against in-process
    run_chunk_full as they are made."""
    return _pooled_against_inprocess(service, "cpu")


def test_pooled_full_chain_matches_inprocess(cpu_pooled):
    assert len(cpu_pooled) == 3


def test_pooled_full_chain_matches_jax_pool(service, cpu_pooled):
    """The JAX package's HostPool + run_chunk_full_pooled on the same
    service, 2 lanes / 2 workers / 3 ticks (tests/test_hostpool.py):
    every TickResult field equals the port's pooled run exactly, but
    the planes, which the JAX pooled path does not return (the port's
    are held against in-process run_chunk_full in `cpu_pooled`)."""
    from espflix_tpu.runtime.hostpool import HostPool as JHostPool
    from espflix_tpu.runtime.scheduler import Fleet as JFleet
    n = 2
    jf = JFleet(n, words_per_lane=8192, parser="pallas", output=True)
    pool = JHostPool(n, 2, 8192, jf.mb_w, jf.mb_h)
    try:
        for i in range(n):
            assert pool.attach(i, service)
            pool.call(i, "nav", 0)
            pool.call(i, "play_pause")
        jgot = jf.run_chunk_full_pooled(pool, 3, tap_lanes=(0,))
    finally:
        pool.close()
    assert all(r.y is None and r.u is None and r.v is None for r in jgot)
    assert all(torch.is_tensor(r.y) for r in cpu_pooled)
    _assert_results_equal(
        jgot, cpu_pooled, [f.name for f in dataclasses.fields(TickResult)
                           if f.name not in "yuv"])


def _payload_lens(svc_dir: str) -> list[int]:
    """Byte lengths of the pictures of a service's first title, in
    stream order."""
    feed = StreamFeed()
    with open(f"{svc_dir}/media/t/video.ts", "rb") as f:
        feed.feed(f.read())
    feed.eos()
    out = []
    while (p := feed.pop_picture()) is not None:
        out.append(len(p.payload))
    return out


@pytest.fixture(scope="module")
def reject_services(tmp_path_factory):
    """(normal, big, sliced, words_per_lane): three one-title services.
    `big` holds denser content; words_per_lane is set so that its first
    picture is one to three bytes past a lane (its byte length rounded
    DOWN to words would still fit), and every picture of `normal` fits.
    `sliced` repeats the last slice of every GOP's second picture, so
    that picture has one slice more than the MB rows."""
    root = tmp_path_factory.mktemp("svcpool_reject")
    normal = str(root / "normal")
    make_service(normal, ["t"], seed=3, n_gops=2, gop=4)
    for seed in range(64):
        big = str(root / f"big{seed}")
        make_service(big, ["t"], seed=seed, n_gops=2, gop=4, i_coeffs=24,
                     p_coeffs=24)
        first = _payload_lens(big)[0]
        if first % 4:
            break
    wpl = first // 4 + 4
    assert (first + 3) // 4 + 4 > wpl
    assert max(_payload_lens(normal)) <= 4 * (wpl - 4)

    plain = indexer.realistic_gop_script

    def extra_slice(rng, n_pictures, **kw):
        script = plain(rng, n_pictures=n_pictures, **kw)
        pics = script["pictures"]
        if len(pics) > 1:
            pics[1]["slices"].append(dict(pics[1]["slices"][-1]))
        return script
    sliced = str(root / "sliced")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(indexer, "realistic_gop_script", extra_slice)
        make_service(sliced, ["t"], seed=5, n_gops=2, gop=4)
    return "file://" + normal, "file://" + big, "file://" + sliced, wpl


def test_pooled_rejects_like_inprocess(reject_services):
    """Four lanes on two workers (normal, oversize by 1-3 bytes, one
    slice too many, normal), two ticks: the workers drop and re-seek
    what the in-process fleet drops and re-seeks, log the same events
    (LANE_OVERSIZE with the byte size, LANE_RESYNC) through the parent,
    and every TickResult field equals in-process run_chunk_full."""
    normal, big, sliced, wpl = reject_services
    urls = [normal, big, sliced, normal]
    n = len(urls)
    f1 = Fleet(n, words_per_lane=wpl, parser="pallas", output=True,
               device="cpu")
    for i, u in enumerate(urls):
        s = PlayerSession(u)
        assert s.init_service()
        s.nav(0)
        s.play_pause()
        f1.attach(i, s)
    ref = f1.run_chunk_full(2, tap_lanes=(1,))

    f2 = Fleet(n, words_per_lane=wpl, parser="pallas", output=True,
               device="cpu")
    with HostPool(n, 2, wpl, f2.mb_w, f2.mb_h) as pool:
        for i, u in enumerate(urls):
            assert pool.attach(i, u)
            pool.call(i, "nav", 0)
            pool.call(i, "play_pause")
        got = f2.run_chunk_full_pooled(pool, 2, tap_lanes=(1,))
    _assert_results_equal(ref, got)
    ev = _events(f2)
    assert ev == _events(f1)
    over = [e for e in ev if e[0] == "LANE_OVERSIZE"]
    assert {e[1] for e in over} == {1, 2}
    assert ("LANE_RESYNC", 1) in [e[:2] for e in ev]
    assert ("LANE_RESYNC", 2) in [e[:2] for e in ev]
    assert any(r.video_lanes[0] and r.video_lanes[3] for r in got)


@pytest.mark.gpu
def test_pooled_full_chain_on_card(service):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _pooled_against_inprocess(service, "cuda")
