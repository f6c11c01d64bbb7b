"""The full per-tick chain: the port's run_full_chunk vs the JAX package.

K=3 ticks, 4 lanes, 352x192 realistic I/P content built like bench.py
--stage full (espflix_tpu_torch.runtime.workload), tap=1, with host row
windows (win=0) and device windows (win>0): every out and every carry
(frames, parity, SBC history, PDM state) of the port on the CPU equals
espflix_tpu.runtime.chain.run_full_chunk(interpret=True).  The
scrolled chain (flip animation mid-slide on some lanes) equals the JAX
chain's scrolled run in both window modes.  Plus: the port, its fleet
and its serving tool import no jax, and a 2-lane CPU serve runs.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from espflix_tpu.models import mpeg1 as JM
from espflix_tpu.models import sbc as JS
from espflix_tpu.runtime import chain as JCH
from espflix_tpu_torch.runtime import chain as TCH
from espflix_tpu_torch.runtime.workload import bench_chunk

torch.set_num_threads(1)

LANES, TICKS = 4, 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_both(win: bool, scrolled: bool = False, jax_side: bool = True):
    xs, kw = bench_chunk(LANES, n_pictures=TICKS, win=win, starve_p=0.3,
                         long_rows=3 * 12)
    tap_idx = np.array([2], np.int32)
    frames = {k: np.asarray(v) for k, v in
              JM.init_frame_state(LANES, 352, 192).items()}
    # a lived-in start state: random reference planes and carries
    rng = np.random.default_rng(8)
    for k in "yuv":
        frames[k] = rng.integers(0, 249, frames[k].shape, dtype=np.uint8)
    frames["parity"] = rng.integers(0, 2, LANES).astype(np.int32)
    sbc = np.asarray(JS.init_state(LANES))
    ds = rng.integers(-9000, 9000, (LANES, 3)).astype(np.int32)
    slide = None
    if scrolled:
        # mid-slide lanes 0 and 2 (both directions; lane 2 is tapped)
        # at a different scroll each tick, against random outgoing
        # planes; lanes 1 and 3 are not animating
        kw["scrolled"] = True
        xs["hscroll"] = np.zeros((TICKS, LANES), np.int32)
        xs["hscroll"][:, 0] = [-344, -175, -1][:TICKS]
        xs["hscroll"][:, 2] = [352, 136, 8][:TICKS]
        slide = tuple(rng.integers(0, 256, frames[k].shape[:1]
                                   + frames[k].shape[2:], dtype=np.uint8)
                      for k in "yuv")

    j = None
    if jax_side:
        j_slide = tuple(jnp.asarray(a) for a in slide) if scrolled else \
            (jnp.zeros((1, 1, 1), jnp.uint8),) * 3
        j = JCH.run_full_chunk(
            {k: jnp.asarray(v) for k, v in xs.items()},
            {k: jnp.asarray(v) for k, v in frames.items()},
            jnp.asarray(sbc), jnp.asarray(ds), jnp.asarray(tap_idx),
            j_slide, tap=1, interpret=True, **kw)
        j = jax.tree_util.tree_map(np.asarray, j)

    fr_t, sbc_t, ds_t = TCH.state_from_numpy(frames, sbc, ds, "cpu")
    t_slide = tuple(torch.from_numpy(a) for a in slide) if scrolled \
        else None
    t = TCH.run_full_chunk(
        TCH.xs_to_torch(xs, "cpu"), fr_t, sbc_t, ds_t,
        torch.from_numpy(tap_idx), t_slide, tap=1, **kw)
    fr2, sbc2, ds2 = TCH.state_to_numpy(*t[:3])
    outs = {k: v.numpy() for k, v in t[3].items()}
    return j, (fr2, sbc2, ds2, outs), xs


@pytest.fixture(scope="module", params=[False, True], ids=["win0", "win"])
def both(request):
    return _run_both(request.param)


OUT_KEYS = ("err", "audio_err", "field_sum", "pdm_sum", "y", "u", "v",
            "tap_fields", "tap_pdm")


@pytest.mark.parametrize("key", OUT_KEYS)
def test_outs_match(both, key):
    j, t, _xs = both
    a, b = t[3][key], j[3][key]
    assert a.dtype == b.dtype and a.shape == b.shape, key
    assert np.array_equal(a, b), key


@pytest.mark.parametrize("key", ["y", "u", "v", "parity"])
def test_frame_carry_matches(both, key):
    j, t, _xs = both
    assert t[0][key].dtype == j[0][key].dtype
    assert np.array_equal(t[0][key], j[0][key])


def test_audio_carries_match(both):
    j, t, _xs = both
    assert np.array_equal(t[1], j[1]) and t[1].dtype == j[1].dtype
    assert np.array_equal(t[2], j[2]) and t[2].dtype == j[2].dtype


def test_chunk_exercises_the_tick(both):
    """Not a degenerate chunk: decoded video, I and P pictures, live,
    beeping and starved audio lanes, no lane errors."""
    _j, t, xs = both
    assert not t[3]["err"].any()
    assert set(np.unique(xs["pic_type"][xs["alive"] == 1])) == {1, 2}
    assert (xs["beep_left"] > 0).any() and xs["starved"].any()
    assert (t[3]["tap_pdm"] != 0xAAAA).any()
    assert t[3]["y"].std() > 0


def test_scrolled_chain_not_ported():
    """The scrolled chain, which the port once raised on, now runs: in
    both window modes every out and carry equals the JAX chain's
    scrolled run, the tapped mid-slide lane's fields differ from an
    unscrolled run, and the presented planes stay unscrolled."""
    for win in (False, True):
        j, t, _xs = _run_both(win, scrolled=True)
        for key in OUT_KEYS:
            a, b = t[3][key], j[3][key]
            assert a.dtype == b.dtype and a.shape == b.shape, key
            assert np.array_equal(a, b), (win, key)
        for key in ("y", "u", "v", "parity"):
            assert np.array_equal(t[0][key], j[0][key]), (win, key)
        assert np.array_equal(t[1], j[1]) and np.array_equal(t[2], j[2])
        _j0, t0, _ = _run_both(win, jax_side=False)
        assert np.array_equal(t[3]["y"], t0[3]["y"])
        assert not np.array_equal(t[3]["tap_fields"], t0[3]["tap_fields"])
        assert not np.array_equal(t[3]["field_sum"][:, 0],
                                  t0[3]["field_sum"][:, 0])
        assert np.array_equal(t[3]["field_sum"][:, [1, 3]],
                              t0[3]["field_sum"][:, [1, 3]])


def test_port_imports_no_jax(tmp_path):
    """Importing the port, running a tiny chain and a 2-lane, 1-chunk
    serve of the port's fleet on the CPU never imports jax (the card's
    machine has none)."""
    code = (
        "import sys, torch\n"
        "import espflix_tpu_torch\n"
        "from espflix_tpu_torch.runtime import chain as C\n"
        "from espflix_tpu_torch.runtime.workload import bench_chunk\n"
        "from espflix_tpu_torch.models import mpeg1 as M, sbc as S\n"
        "from espflix_tpu_torch.ops import delta_sigma as D\n"
        "from espflix_tpu_torch.runtime import scheduler, player, output\n"
        "from espflix_tpu_torch.tools import serve_scenario as SS\n"
        "import espflix_tpu_torch.build\n"
        "xs, kw = bench_chunk(3, n_pictures=2, long_rows=35)\n"
        "xs = {k: v[:1] for k, v in xs.items()}\n"
        "fr = M.init_frame_state(3, 352, 192, 'cpu')\n"
        "out = C.run_full_chunk(C.xs_to_torch(xs, 'cpu'), fr,\n"
        "    S.init_state(3, 'cpu'), D.init_state(3, 'cpu'),\n"
        "    torch.zeros(1, dtype=torch.int32), None, tap=1, **kw)\n"
        "assert not out[3]['err'].any()\n"
        "root = sys.argv[1]\n"
        "SS.generate_service(root, ['a', 'b'], seed=1, n_gops=1)\n"
        "fleet = SS.build_fleet('file://' + root, 2, 2, stage='full',\n"
        "                       device='cpu')\n"
        "rs = fleet.run_chunk_full(2, tap_lanes=(1,))\n"
        "assert len(rs) == 2 and sum(int(r.video_lanes.sum()) "
        "for r in rs) == 4\n"
        "assert not any(r.errors.any() for r in rs)\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "print('no-jax-ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "no-jax-ok" in r.stdout
