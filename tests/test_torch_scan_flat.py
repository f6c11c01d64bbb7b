"""Slice scan into lane-minor buffers: the port vs the JAX package.

The port's run_scan_bucketed (plain lockstep FSM, each step's emissions
set into one [recs | nfinal | coeffs | trash] buffer per lane; kernel
K1F on a card) must reproduce, exactly, in coeffs, recs, nfinal, err
and iters:

  * vlc_scan_pallas.run_scan_pallas_bucketed (interpret mode) on
    span-sorted rows in two budget buckets -- the run_chunk path;
  * vlc_scan_pallas.run_scan_pallas_sliced (interpret mode) on unsorted
    rows with one budget (long_rows = NS, chunks of 256) -- the
    small-fleet tick path.

Cases: realistic 352x192 I/P lanes, lanes that overflow a small step
budget, and a lane carrying serve_scenario.corrupt_picture() (an
invalid MB type).  A picture that claims one slice row twice is left
out on purpose: both JAX launchers resolve two emissions into one slot
with a single scatter whose order XLA does not specify, and K1F's
threads race there too, so no answer is the contract (the dense tick
path flags such lanes as errors instead; tests/test_torch_scan.py).
"""

import numpy as np
import pytest
import torch

from espflix_tpu_torch.models import mpeg1 as TM
from espflix_tpu_torch.ops import vlc_scan as TVS
from espflix_tpu_torch.tools import mpeg1_encode as E
from espflix_tpu_torch.tools.content import realistic_gop_script
from espflix_tpu_torch.tools.serve_scenario import corrupt_picture

try:
    import jax.numpy as jnp
    from espflix_tpu.ops import vlc_scan_pallas as JVP
except ImportError:     # the card's machine has no jax: gpu tests only
    jnp = JVP = None

torch.set_num_threads(1)

KEYS = TM.SCAN_KEYS
OUTS = ("coeffs", "recs", "nfinal", "err", "iters")


def _pictures():
    return TM.parse_es(E.encode_es(realistic_gop_script(
        np.random.default_rng(1000), n_pictures=4)))[1]


PICS = _pictures()

# name: (picture per lane (None = corrupt), sorted rows + two buckets?,
#        long_rows, steps_long, steps_short, chunk)
CASES = {
    "two_buckets_352x192": ([0, 1, 2, 3], True, 16, 1024, 384, 128),
    "budget_overflow": ([0, 1, 3], True, 6, 1024, 40, 128),
    "uniform_sliced": ([1, 0], False, None, 2048, 2048, 256),
    "corrupt_lane_sliced": ([2, None, 3], False, None, 2048, 2048, 256),
}


def _case(name):
    sel, bucketed, long_rows, s_long, s_short, chunk = CASES[name]
    pics = [PICS[i] if i is not None else corrupt_picture() for i in sel]
    b = TM.make_picture_batch(pics, words_per_lane=8192, max_slices=12)
    sl = TVS.pack_slice_rows(b, sort_rows=bucketed)
    NS = len(sl["rows"])
    kw = dict(mb_width=22, mb_height=12, n_lanes=len(sel),
              long_rows=long_rows or NS, steps_long=s_long,
              steps_short=s_short, chunk=chunk)
    return sl, bucketed, kw


def _port(sl, kw, device="cpu"):
    lut = torch.from_numpy(TVS._mega_lut_np()[0]).to(device)
    zz = torch.from_numpy(TVS.ZZ_NP).to(device)
    out = TVS.run_scan_bucketed(*TM.xs_to_torch({k: sl[k] for k in KEYS},
                                                device).values(),
                                lut=lut, zigzag=zz, **kw)
    return [a.cpu().numpy() for a in out]


def _jax(sl, bucketed, kw):
    args = [jnp.asarray(sl[k]) for k in KEYS]
    mb_count = kw["mb_width"] * kw["mb_height"]
    if bucketed:
        out = JVP.run_scan_pallas_bucketed(
            *args, mb_width=kw["mb_width"], mb_count=mb_count,
            n_lanes=kw["n_lanes"], long_rows=kw["long_rows"],
            steps_long=kw["steps_long"], steps_short=kw["steps_short"],
            chunk=kw["chunk"], interpret=True)
    else:
        out = JVP.run_scan_pallas_sliced(
            *args[:7], mb_width=kw["mb_width"], mb_count=mb_count,
            max_steps=kw["steps_long"], out_groups=sl["out_groups"],
            chunk=kw["chunk"], interpret=True)
    return [np.asarray(a) for a in out]


@pytest.fixture(scope="module")
def results():
    out = {}
    for name in CASES:
        sl, bucketed, kw = _case(name)
        out[name] = (_jax(sl, bucketed, kw), _port(sl, kw))
    return out


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("i,name", list(enumerate(OUTS)))
def test_flat_scan_matches_jax(results, case, i, name):
    j, t = results[case]
    assert t[i].dtype == j[i].dtype, name
    assert t[i].shape == j[i].shape, name
    assert np.array_equal(t[i], j[i]), name


def test_cases_exercise_the_edges(results):
    """The fixture covers what the cases are named for: clean lanes
    decode without error, the short budget overflows, the corrupt lane
    and only it errors, and the uniform cases scan unsorted rows."""
    err = {name: r[1][3].tolist() for name, r in results.items()}
    assert err["two_buckets_352x192"] == [False] * 4
    assert err["uniform_sliced"] == [False] * 2
    assert any(err["budget_overflow"])
    assert err["corrupt_lane_sliced"] == [False, True, False]
    sl, _b, kw = _case("uniform_sliced")
    assert kw["long_rows"] == len(sl["rows"])
    assert (np.diff(sl["lane_of_row"]) >= 0).all()
    assert results["two_buckets_352x192"][1][0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_flat_kernel_matches_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sl, _bucketed, kw = _case(case)
    for a, b in zip(_port(sl, kw, "cuda"), _port(sl, kw)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
