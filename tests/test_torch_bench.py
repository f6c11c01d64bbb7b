"""The port's bench (tools/bench.py) against the JAX package's bench.py.

  * the device and hybrid routes at --stage decode, 2-4 lanes x 2
    pictures: each chunk's checksum equals bench.py's formula (y + the
    error flags, int32 wraparound) on the JAX package's decode of the
    same pictures (the chain route's checksum is held against the JAX
    chain in tests/test_torch_chain.py, on that file's JAX run);
  * the realtime probe on synthetic tick models gives the lanes of
    bench.py's own algorithm (bench.py:559-610, transcribed below with
    make_builders replaced by the model): the 8,192 cap binding, a
    refit that steps down, the 128 floor and the measured headline;
  * a CPU run of the CLI prints a last line with every key of bench.py's
    line plus backend, device and power_limit_w; without --device cpu,
    on a host with no card, the bench refuses to run;
  * on a card (gpu-marked): every route's chunk checksum equals the same
    route through the plain forms on the CPU.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from espflix_tpu_torch.models import mpeg1 as TM
from espflix_tpu_torch.runtime.workload import bench_pictures
from espflix_tpu_torch.tools import bench as TB
from espflix_tpu_torch.tools import oracle as TO

try:
    import jax.numpy as jnp
    from espflix_tpu.models import mpeg1 as JM
    from espflix_tpu.tools import oracle as JO
except ImportError:     # the card's machine has no jax: gpu tests only
    jnp = JM = JO = None

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _args(*extra):
    return TB.parse_args(["--device", "cpu", "--pictures", "2",
                          "--stage", "decode", *extra])


def _wrap32(v: int) -> int:
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


def _jax_checksum(pictures, infos) -> int:
    """bench.py's per-tick y + error sum over a chunk (int32 wrap)."""
    return _wrap32(sum(int(np.asarray(p["y"]).astype(np.int64).sum())
                       + int(np.asarray(i["error"]).sum())
                       for p, i in zip(pictures, infos)))


def test_device_route_matches_jax():
    lanes = 2
    route = TB.build_device(_args("--pipeline", "device"), lanes, CPU)
    _state, chk = route.chunk(route.init())
    ticks, wpl = bench_pictures(lanes, n_pictures=2)
    frames = JM.init_frame_state(lanes, 352, 192)
    pics, infos = [], []
    for sel in ticks:
        b = TM.make_picture_batch(sel, words_per_lane=wpl, max_slices=12)
        frames, p, info = JM.decode_picture_batch(
            *[jnp.asarray(b[k]) for k in TM.PICTURE_KEYS], frames,
            mb_width=22, mb_height=12, max_steps=min(wpl * 32, 12000))
        pics.append(p)
        infos.append(info)
    assert int(chk) == _jax_checksum(pics, infos)
    assert chk.dtype == torch.int32
    assert {sel[0].pic_type for sel in ticks} | \
        {sel[1].pic_type for sel in ticks} == {1, 2}


def test_hybrid_route_matches_jax():
    if not (TO.available() and JO.available()):
        pytest.skip("tokenizer library not buildable")
    lanes = 4
    route = TB.build_hybrid(_args("--pipeline", "hybrid"), lanes, CPU)
    n, ts, chks = route.run(2)
    assert n == 4 and len(ts) == 2
    ticks, _wpl = bench_pictures(lanes, n_pictures=2)
    iqs = [np.stack([p.seq.intra_q for p in sel]) for sel in ticks]
    nqs = [np.stack([p.seq.non_intra_q for p in sel]) for sel in ticks]
    frames = JM.init_frame_state(lanes, 352, 192)

    def dec(frames, k):
        return JM.decode_picture_batch_hybrid(
            ticks[k], iqs[k], nqs[k], frames, mb_width=22, mb_height=12)
    frames = dec(frames, 0)[0]               # the warm picture
    want = []
    for _rep in range(2):
        pics, infos = [], []
        for k in range(len(ticks)):
            frames, p, info = dec(frames, k)
            pics.append(p)
            infos.append(info)
        want.append(_jax_checksum(pics, infos))
    assert chks == want


# ---- the realtime probe ----------------------------------------------------

def _jax_probe(run_ticks, lanes, dt, n, ts, k, reps):
    """bench.py:559-610 as written there, with `make_builders(N)[...]()
    ... run(r)` replaced by run_ticks(N, r) -> chunk seconds."""
    deadline = 1.0 / 30.0
    tick1 = dt / n                        # s/tick at `lanes`
    n2 = max(128, (lanes // 2) // 128 * 128)
    ts2 = run_ticks(n2, 2)
    tick2 = min(ts2) / k
    b = (tick1 - tick2) / max(lanes - n2, 1)
    a = tick1 - b * lanes
    cand = int((deadline - a) / b) if b > 0 else lanes
    cand = min(max(cand // 32 * 32, 128), 8192)
    rt_lanes, p50, p99 = None, None, None
    for _try in range(6):
        if cand == lanes:
            tcks = [t / k for t in ts]
        else:
            tsc = run_ticks(cand, max(reps, 8))
            tcks = [t / k for t in tsc]
        tcks.sort()
        q50 = tcks[len(tcks) // 2]
        q99 = tcks[min(len(tcks) - 1, int(len(tcks) * 0.99))]
        if q50 <= deadline or cand <= 128:
            rt_lanes, p50, p99 = cand, q50, q99
            break
        if b > 0:
            nxt = int((deadline - (q50 - b * cand)) / b)
        else:
            nxt = cand - 32
        cand = max(min(nxt // 32 * 32, cand - 32), 128)
    return {"realtime_lanes": rt_lanes,
            "tick_p50_ms": round(p50 * 1000, 2) if p50 else None,
            "tick_p99_ms": round(p99 * 1000, 2) if p99 else None}


def _model(fn, k=12):
    """A synthetic bench: fn(N, i) -> seconds a tick of chunk i at N
    lanes; run_ticks(N, reps) gives chunk seconds, tick_times (the
    port's callable) seconds a tick; every probed N is recorded."""
    seen = []

    def run_ticks(n, reps):
        seen.append(n)
        return [fn(n, i) * k for i in range(reps)]

    def tick_times(n, reps):
        return [t / k for t in run_ticks(n, reps)]
    return run_ticks, tick_times, seen


@pytest.mark.parametrize("case", ["cap", "step_down", "floor", "headline",
                                  "flat"])
def test_realtime_probe_matches_jax_algorithm(case):
    lanes, reps, k = 1024, 2, 12
    jitter = [1.0, 1.02, 0.99, 1.05, 1.0, 0.97, 1.01, 1.03]
    fns = {
        # ~2.3 ms at 1,024 lanes: the model predicts ~15k lanes
        "cap": lambda n, i: (0.3e-3 + 2e-6 * n) * jitter[i % 8],
        # superlinear: the linear fit overshoots, the refit jumps down
        "step_down": lambda n, i: (1e-3 + 10e-6 * n + 2e-9 * n * n)
        * jitter[i % 8],
        # far too slow even at 128 lanes
        "floor": lambda n, i: 0.05 + 1e-6 * n,
        # the model lands on the headline's own lane count
        "headline": lambda n, i: 1.3e-3 + (32e-3 / 1024) * n,
        # no slope (b = 0) and over the deadline
        "flat": lambda n, i: 0.040,
    }
    run_ticks, tick_times, seen = _model(fns[case], k)
    ts = run_ticks(lanes, reps)
    dt, n = sum(ts), reps * k
    want = _jax_probe(run_ticks, lanes, dt, n, ts, k, reps)
    jax_seen = list(seen)
    seen.clear()
    got, capped = TB.realtime_probe(tick_times, lanes, dt / n,
                                    [t / k for t in ts], reps)
    assert got == want and seen == jax_seen[1:]
    assert capped == (case == "cap")
    # seen: the half-lanes run, then each candidate tried
    expect = {"cap": lambda r: r == 8192 and seen[1:] == [8192],
              "step_down": lambda r: len(seen) >= 3 and r == seen[-1]
              < seen[-2],
              "floor": lambda r: r == 128,
              "headline": lambda r: r == lanes and len(seen) == 1,
              # b = 0: 32 lanes a try from the headline, six misses
              "flat": lambda r: r is None and len(seen) == 6}
    assert expect[case](got["realtime_lanes"]), (got, seen)


# ---- the CLI ---------------------------------------------------------------

def _jax_line_keys() -> set:
    """The constant keys of the dict bench.py prints as its last line."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "metric"
                for k in node.keys):
            keys = {k.value for k in node.keys if isinstance(k, ast.Constant)}
            # **realtime: bench.py:603-607 and the error key of :609
            return keys | {"realtime_lanes", "tick_p50_ms", "tick_p99_ms"}
    raise AssertionError("bench.py prints no metric line")


def test_cli_prints_the_jax_line_and_names_the_backend():
    r = subprocess.run(
        [sys.executable, "-m", "espflix_tpu_torch.tools.bench", "--device",
         "cpu", "--lanes", "2", "--pictures", "2", "--reps", "1",
         "--no-realtime", "--stage", "decode"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    realtime = {"realtime_lanes", "tick_p50_ms", "tick_p99_ms"}
    assert set(line) == (_jax_line_keys() - realtime) | {
        "backend", "device", "power_limit_w"}
    assert line["metric"] == "realtime_352x192_mpeg1_streams_per_chip"
    assert (line["backend"], line["device"], line["power_limit_w"]) == \
        ("cpu", "cpu", None)
    assert (line["pipeline"], line["scatter"], line["idct"],
            line["mocomp"]) == ("pallas", "K1", "K2", "K3")
    assert line["fallback_reason"] is None and line["lanes"] == 2
    assert line["value"] > 0 and line["stage"] == "decode"


def test_bench_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        TB.main(["--lanes", "2", "--pictures", "2", "--no-realtime"])
    assert "no CUDA device" in str(e.value)


@pytest.mark.gpu
def test_routes_on_card_match_plain():
    """Each route's chunk checksum on the card (the kernels) equals the
    same route on the CPU (the plain forms), 16 lanes x 2 pictures."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda = torch.device("cuda")
    for extra in (["--pipeline", "pallas", "--stage", "full"],
                  ["--pipeline", "pallas", "--stage", "full", "--scrolled",
                   "--standard", "pal"],
                  ["--pipeline", "pallas"],
                  ["--pipeline", "device", "--stage", "full"],
                  ["--pipeline", "hybrid"]):
        args = _args(*extra)
        routes = [TB.make_builders(args, 16, dev)[args.pipeline]()
                  for dev in (cuda, CPU)]
        got, want = (int(r.chunk(r.init())[1]) for r in routes)
        assert got == want, extra
