"""The full per-tick chain: the port's run_full_chunk vs the JAX package.

K=3 ticks, 4 lanes, 352x192 realistic I/P content built like bench.py
--stage full (espflix_tpu_torch.runtime.workload), tap=1, with host row
windows (win=0) and device windows (win>0): every out and every carry
(frames, parity, SBC history, PDM state) of the port on the CPU equals
espflix_tpu.runtime.chain.run_full_chunk(interpret=True).  Plus: the
port imports no jax, and the unported scrolled path raises.
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


def _run_both(win: bool):
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

    j = JCH.run_full_chunk(
        {k: jnp.asarray(v) for k, v in xs.items()},
        {k: jnp.asarray(v) for k, v in frames.items()}, jnp.asarray(sbc),
        jnp.asarray(ds), jnp.asarray(tap_idx),
        (jnp.zeros((1, 1, 1), jnp.uint8),) * 3, tap=1, interpret=True,
        **kw)
    j = jax.tree_util.tree_map(np.asarray, j)

    fr_t, sbc_t, ds_t = TCH.state_from_numpy(frames, sbc, ds, "cpu")
    t = TCH.run_full_chunk(
        TCH.xs_to_torch(xs, "cpu"), fr_t, sbc_t, ds_t,
        torch.from_numpy(tap_idx), None, tap=1, **kw)
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
    with pytest.raises(NotImplementedError):
        TCH.run_full_chunk({}, {"y": torch.zeros(1)}, None, None, None,
                           None, mb_width=1, mb_height=1, n_lanes=1,
                           long_rows=1, steps_long=1, steps_short=1,
                           n_aud_frames=1, channels=1, pal=False,
                           scrolled=True, tap=0)


def test_port_imports_no_jax():
    """Importing the port and running a tiny chain on the CPU never
    imports jax (the card's machine has none)."""
    code = (
        "import sys, torch\n"
        "import espflix_tpu_torch\n"
        "from espflix_tpu_torch.runtime import chain as C\n"
        "from espflix_tpu_torch.runtime.workload import bench_chunk\n"
        "from espflix_tpu_torch.models import mpeg1 as M, sbc as S\n"
        "from espflix_tpu_torch.ops import delta_sigma as D\n"
        "import espflix_tpu_torch.build\n"
        "xs, kw = bench_chunk(3, n_pictures=2, long_rows=35)\n"
        "xs = {k: v[:1] for k, v in xs.items()}\n"
        "fr = M.init_frame_state(3, 352, 192, 'cpu')\n"
        "out = C.run_full_chunk(C.xs_to_torch(xs, 'cpu'), fr,\n"
        "    S.init_state(3, 'cpu'), D.init_state(3, 'cpu'),\n"
        "    torch.zeros(1, dtype=torch.int32), None, tap=1, **kw)\n"
        "assert not out[3]['err'].any()\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "print('no-jax-ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "no-jax-ok" in r.stdout
