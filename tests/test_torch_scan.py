"""Slice scan into dense buffers: the port vs the JAX package.

The port's run_scan_bucketed_dense (plain lockstep FSM + log densify on
the CPU; kernel K1 on a card) must reproduce
vlc_scan_pallas.run_scan_pallas_bucketed_dense(transposed=True) run in
interpret mode: coeffs_T, recs, nfinal, err and iters, exactly, on
random 96x64 content, realistic 352x192 I/P content, rows that overflow
a small step budget, a corrupt picture and duplicate slice claims.
"""

import dataclasses

import numpy as np
import pytest
import torch

from espflix_tpu.core.bitio import BitWriter
from espflix_tpu.tools import mpeg1_encode as E
from espflix_tpu.tools.content import realistic_gop_script
from espflix_tpu_torch.models import mpeg1 as TM
from espflix_tpu_torch.ops import scan_dense as TSD
from espflix_tpu_torch.ops import vlc_scan as TVS

try:
    import jax.numpy as jnp
    from espflix_tpu.ops import vlc_scan_pallas as JVP
except ImportError:     # the card's machine has no jax: gpu tests only
    jnp = JVP = None

torch.set_num_threads(1)

KEYS = ("words", "start_bits", "rows", "alive", "pic_type", "full_pel",
        "r_size", "lane_of_row")


def corrupt_es(width=96, height=64):
    """An I-picture whose first MB hits an invalid MB-type code (as in
    tests/test_fault_injection.py): a guaranteed decoder error."""
    w = BitWriter()
    w.start_code(0xB3)
    w.put(width, 12); w.put(height, 12); w.put(1, 4); w.put(5, 4)
    w.put(2928, 18); w.put(1, 1); w.put(20, 10)
    w.put(0, 1); w.put(0, 1); w.put(0, 1)
    w.start_code(0x00)
    w.put(0, 10); w.put(1, 3); w.put(0xFFFF, 16); w.put(0, 1)
    w.start_code(0x01)
    w.put(8, 5); w.put(0, 1)
    w.put_str("1")            # addr_inc = 1
    w.put(0, 23)              # invalid MB type, not a start code yet
    w.put(0xFFFF, 16)
    w.align()
    w.start_code(0xB7)
    return w.tobytes()


def _rows(pics, n, dup_first_slice=False):
    """Span-sorted scan rows + perm for lanes cycling over `pics`."""
    sel = [pics[i % len(pics)] for i in range(n)]
    if dup_first_slice:
        # lane 0 carries its first slice twice: two rows claim one MB row
        p = sel[0]
        sel[0] = dataclasses.replace(
            p, slice_offsets=[p.slice_offsets[0]] + p.slice_offsets,
            slice_rows=[p.slice_rows[0]] + p.slice_rows)
    seq = pics[0].seq
    wpl = max((len(p.payload) + 3) // 4 + 4 for p in sel)
    b = TM.make_picture_batch(sel, words_per_lane=wpl,
                              max_slices=seq.mb_height + 1)
    sl = TVS.pack_slice_rows(b, sort_rows=True)
    perm, dup = TSD.row_perm(sl["lane_of_row"], sl["rows"], sl["alive"],
                             n, seq.mb_height)
    return sl, perm, dup, seq


def _cases():
    rng = np.random.default_rng(5)
    small = TM.parse_es(E.encode_es(E.random_script(
        rng, n_pictures=3, max_coeffs=10, width=96, height=64)))[1]
    real = TM.parse_es(E.encode_es(realistic_gop_script(
        np.random.default_rng(1000), n_pictures=4)))[1]
    bad = TM.parse_es(corrupt_es())[1]
    rng = np.random.default_rng(9)
    good = TM.parse_es(E.encode_es(E.random_script(
        rng, n_pictures=1, max_coeffs=8, width=96, height=64)))[1]
    return {
        # name: (pictures, lanes, long_rows, steps_long, steps_short, dup)
        "random_96x64": (small, 6, 8, 1024, 384, False),
        "realistic_352x192_ip": (real, 5, 24, 1024, 384, False),
        "budget_overflow": (real, 4, 6, 1024, 40, False),
        "corrupt_lane": ([good[0], bad[0]], 3, 4, 1024, 384, False),
        "duplicate_slice": (small, 3, 4, 1024, 384, True),
    }


CASES = _cases()


def _case_inputs(name):
    pics, n, long_rows, sl_, ss, dup_first = CASES[name]
    sl, perm, dup, seq = _rows(pics, n, dup_first)
    kw = dict(mb_width=seq.mb_width, mb_height=seq.mb_height,
              n_lanes=n, long_rows=long_rows, steps_long=sl_,
              steps_short=ss, chunk=128)
    args = [torch.from_numpy(np.ascontiguousarray(sl[k]).view(np.int32)
                             if sl[k].dtype == np.uint32 else sl[k])
            for k in KEYS] + [torch.from_numpy(perm)]
    return sl, perm, dup, args, kw


def _port_scan(args, kw, device="cpu"):
    lut = torch.from_numpy(TVS._mega_lut_np()[0]).to(device)
    zz = torch.from_numpy(TVS.ZZ_NP).to(device)
    out = TVS.run_scan_bucketed_dense(*[a.to(device) for a in args],
                                      lut=lut, zigzag=zz, **kw)
    return [a.cpu().numpy() for a in out]


@pytest.fixture(scope="module")
def results():
    out = {}
    for name in CASES:
        sl, perm, dup, args, kw = _case_inputs(name)
        j = JVP.run_scan_pallas_bucketed_dense(
            *[jnp.asarray(sl[k]) for k in KEYS], jnp.asarray(perm),
            block_rows=1024, interpret=True, transposed=True, **kw)
        out[name] = ([np.asarray(a) for a in j], _port_scan(args, kw), dup)
    return out


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("i,name", list(enumerate(
    ("coeffs_T", "recs", "nfinal", "err", "iters"))))
def test_scan_output_matches_jax(results, case, i, name):
    j, t, _dup = results[case]
    assert t[i].dtype == j[i].dtype, name
    assert t[i].shape == j[i].shape, name
    assert np.array_equal(t[i], j[i]), name


def test_cases_exercise_the_edges(results):
    """The fixture really covers what the cases are named for."""
    assert not results["random_96x64"][1][3].any()
    assert not results["realistic_352x192_ip"][1][3].any()
    assert results["budget_overflow"][1][3].any()
    assert results["corrupt_lane"][1][3].tolist() == [False, True, False]
    assert results["duplicate_slice"][2][0]          # lane 0 dup claim


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _sl, _perm, _dup, args, kw = _case_inputs(case)
    for a, b in zip(_port_scan(args, kw, "cuda"), _port_scan(args, kw)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
