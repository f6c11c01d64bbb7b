"""K1S's split of the sequential scan at slice starts, composed on the CPU.

The card runs the device parser's sequential scan as one thread per
(lane, slice), then rebuilds each lane's sequential outcome from the
slices' step counts (vlc_scan.resolve_slices) and scans again, in order,
the lanes the split cannot reproduce.  Here the same split is composed
from plain pieces: vlc_scan.scan_slices_torch (every slice scanned
alone, its emissions stored into its lane's buffers), resolve_slices,
and run_scan_torch over the lanes marked for redo.  It must equal the
JAX package's vlc_scan.run_scan (the XLA while loop) and the port's
lockstep run_scan_torch exactly -- coeffs, recs, nfinal, err and iters
-- on clean multi-slice I and P pictures with an idle lane, a corrupt
slice in the middle of a picture, budget cuts inside a later slice, a
payload cut short and two slices claiming one MB row.  Last, the compact LUT the scan kernels keep in shared memory
expands back to the unified LUT, and follows the unified LUT it is
gathered from.
"""

import dataclasses

import numpy as np
import pytest
import torch

from espflix_tpu_torch.models import mpeg1 as TM
from espflix_tpu_torch.ops import vlc_scan as TVS
from espflix_tpu_torch.tools import mpeg1_encode as TE
from espflix_tpu_torch.tools.content import realistic_gop_script
from espflix_tpu_torch.tools.serve_scenario import corrupt_slice

try:
    import jax.numpy as jnp
    from espflix_tpu.ops import vlc_scan as JVS
except ImportError:     # the card's machine has no jax: gpu tests only
    jnp = JVS = None

torch.set_num_threads(1)

KEYS = ("words", "slice_starts", "slice_rows", "n_slices", "pic_type",
        "full_pel", "r_size")
def pictures(seed, n_pictures=3, max_coeffs=10):
    rng = np.random.default_rng(seed)
    es = TE.encode_es(TE.random_script(rng, n_pictures=n_pictures,
                                       max_coeffs=max_coeffs, width=96,
                                       height=64))
    return TM.parse_es(es)[1]


def jax_scan(b, budget):
    mbw, mbh = b["mb_width"], b["mb_height"]
    st0 = JVS.initial_state(len(b["words"]),
                            *(jnp.asarray(b[k]) for k in KEYS[1:]))
    coeffs, recs, nfinal, st, iters = JVS.run_scan(
        jnp.asarray(b["words"]), st0, mbw, mbw * mbh, budget)
    err = np.asarray(st["error"]) | (np.asarray(st["state"])
                                     != JVS.ST_DONE)
    return [np.asarray(a) for a in (coeffs, recs, nfinal)] + [
        err, int(iters)]


def _inputs(b):
    tables = TM.decode_tables("cpu")
    x = list(TM.xs_to_torch({k: b[k] for k in KEYS}, "cpu").values())
    kw = dict(mb_width=b["mb_width"], mb_height=b["mb_height"],
              lut=tables["lut"], zigzag=tables["zigzag"])
    return x, kw


def plain_scan(b, budget):
    x, kw = _inputs(b)
    out = TVS.run_scan_torch(*x, max_steps=budget, **kw)
    return [t.numpy() for t in out[:4]] + [int(out[4])]


def split_scan(b, budget):
    """The card's split from plain pieces; returns the scan's outputs
    and the redo mask."""
    x, kw = _inputs(b)
    coeffs, recs, nfinal, steps, end, lo, hi = TVS.scan_slices_torch(
        *x, budget=budget, **kw)
    err, lane_steps, redo = TVS.resolve_slices(steps, end, lo, hi, x[3],
                                               budget)
    lanes = torch.nonzero(redo)[:, 0]
    if len(lanes):
        c, r, n, _e, _i = TVS.run_scan_torch(
            *[t[lanes] for t in x], max_steps=budget, **kw)
        coeffs[lanes], recs[lanes], nfinal[lanes] = c, r, n
    out = [t.numpy() for t in (coeffs, recs, nfinal, err)]
    return out + [int(lane_steps.max())], redo.numpy()


def assert_all_equal(j, plain, split):
    """The JAX scan's outputs == run_scan_torch's == the split's."""
    for label, t in (("run_scan_torch", plain), ("split", split)):
        for name, a, c in zip(("coeffs", "recs", "nfinal", "err"), j, t):
            assert a.dtype == c.dtype and np.array_equal(a, c), (label, name)
        assert j[4] == t[4], (label, "iters", j[4], t[4])


@pytest.fixture(scope="module")
def mixed():
    """One batch at a budget of 1,500 steps: clean I and P pictures of
    four slices (lanes 0, 1, 3, 6), an idle lane (2), slice 2 of lane
    4's picture corrupt, lane 5 carrying its first slice twice, and
    lane 7 an I picture whose payload the word window cuts short."""
    pics = pictures(1)
    p = pics[0]
    dup = dataclasses.replace(
        p, slice_offsets=[p.slice_offsets[0]] + p.slice_offsets,
        slice_rows=[p.slice_rows[0]] + p.slice_rows)
    big = pictures(7, n_pictures=1, max_coeffs=20)[0]
    b = TM.make_picture_batch([p, pics[1], None, pics[2], p, dup, p, big],
                              max_slices=5)
    corrupt_slice(b, 4, 2)
    cut = int(np.sort(b["n_words"])[-2])
    assert cut < b["n_words"][7]
    b["words"] = np.ascontiguousarray(b["words"][:, :cut])
    return b, jax_scan(b, 1500), plain_scan(b, 1500), split_scan(b, 1500)


def test_split_on_clean_pictures_and_an_idle_lane(mixed):
    """No clean lane, and not the idle one, needs the in-order pass."""
    b, j, t, (s, redo) = mixed
    assert_all_equal(j, t, s)
    clean = [0, 1, 2, 3, 6]
    assert len(b["words"][0]) == b["n_words"][0]
    assert (b["n_slices"][[0, 1, 3, 6]] == 4).all()
    assert set(b["pic_type"][[0, 1, 3]]) == {1, 2}
    assert not j[3][clean].any() and not redo[clean].any()


def test_split_with_a_corrupt_middle_slice(mixed):
    """Slice 2 of lane 4's four errors at its first macroblock: the scan
    stops there, so slice 3 emits nothing (lane 6, the same picture
    clean, fills that MB row)."""
    b, j, t, (s, redo) = mixed
    assert_all_equal(j, t, s)
    assert j[3][4] and redo[4]
    mbw = b["mb_width"]
    row = int(b["slice_rows"][4, 3]) * mbw
    assert not j[1][4, row:row + mbw].any()
    assert j[1][6, row:row + mbw].all()


def test_split_with_two_slices_on_one_mb_row(mixed):
    """Lane 5's two copies of its first slice both run and emit into the
    same MBs, so the lane is scanned again in order (a slot emitted
    twice keeps the later value); it ends clean."""
    _b, j, t, (s, redo) = mixed
    assert_all_equal(j, t, s)
    assert redo[5] and not j[3][5]


@pytest.mark.parametrize("short", [1, 0])
def test_split_at_a_budget_cut_in_a_later_slice(short):
    """The symbol budget ends one step short of what lane 0 (a P
    picture) needs, inside its last slice, or exactly at it; either
    budget cuts lane 1 (an I picture) inside its slice 2."""
    pics = pictures(3)
    b = TM.make_picture_batch([pics[1], pics[0]], max_slices=4)
    x, kw = _inputs(b)
    steps = TVS.scan_slices_torch(*x, budget=4096, **kw)[3]
    budget = int(steps[0].sum()) - short
    assert steps[1, :2].sum() < budget < steps[1, :3].sum()
    j, t, (s, redo) = (jax_scan(b, budget), plain_scan(b, budget),
                       split_scan(b, budget))
    assert_all_equal(j, t, s)
    assert j[3].tolist() == [bool(short), True]
    assert redo.tolist() == [bool(short), True]


def test_split_past_the_words(mixed):
    """Lane 7's payload is cut short: its slices read 0xFFFFFFFF past
    the words, one errors and the slice after it would scan to the
    budget, so the lane is scanned again in order."""
    _b, j, t, (s, redo) = mixed
    assert_all_equal(j, t, s)
    assert j[3][7] and redo[7]


def test_split_on_realistic_352x192_pictures():
    """An I picture's first four slices and a P picture of 12 at the
    bench size (the lane scans only its n_slices slices)."""
    pics = TM.parse_es(TE.encode_es(realistic_gop_script(
        np.random.default_rng(1000), n_pictures=2)))[1]
    b = TM.make_picture_batch(pics, max_slices=12)
    assert list(b["pic_type"]) == [1, 2] and (b["n_slices"] == 12).all()
    b["n_slices"][0] = 4
    j, (s, redo) = jax_scan(b, 12000), split_scan(b, 12000)
    assert_all_equal(j, plain_scan(b, 12000), s)
    assert not j[3].any() and not redo.any()


def expand_compact_lut(compact):
    """The compact LUT back to the unified LUT, read as the step's table
    load in csrc/scan.cu scan_row reads it: a DCT entry from the first
    level at the top DCT_L1_BITS of the 17-bit peek, from its second
    level at the low bits when the first carries LUT_L2."""
    _lut, bases, bits = TVS._mega_lut_np()
    lo_bits = bits["DCT_FIRST"] - TVS.DCT_L1_BITS
    parts = [compact[:bases["DCT_FIRST"]]]
    for name in ("DCT_FIRST", "DCT_NEXT"):
        idx = np.arange(1 << bits[name])
        e = compact[TVS.COMPACT_BASES[name] + (idx >> lo_bits)]
        l2 = (e & TVS.LUT_L2) != 0
        second = compact[np.where(l2, e & 0xFFFFF, 0)
                         + (idx & ((1 << lo_bits) - 1))]
        parts.append(np.where(l2, second, e))
    return np.concatenate(parts).astype(np.int32)


def test_compact_lut_expands_to_the_unified_lut():
    compact = TVS.compact_lut_np()
    assert compact.dtype == np.int32 and len(compact) % 4 == 0
    assert compact.nbytes < 58 * 1024
    assert np.array_equal(expand_compact_lut(compact),
                          TVS._mega_lut_np()[0])


def test_compact_lut_follows_the_callers_lut():
    """compact_lut gathers from the LUT it is given: the MPEG-1 LUT gives
    compact_lut_np, and a LUT changed in a non-DCT entry, in a whole
    first-level DCT slot and inside a long-code slot (in place, so the
    cached table is rebuilt) expands back to the changed LUT."""
    full, bases, bits = TVS._mega_lut_np()
    lut = torch.from_numpy(full.copy())
    assert np.array_equal(TVS.compact_lut(lut).numpy(), TVS.compact_lut_np())
    lo = 1 << (bits["DCT_FIRST"] - TVS.DCT_L1_BITS)
    first = TVS.compact_lut_np()[TVS.COMPACT_BASES["DCT_NEXT"]:][:lo * 2]
    slot = int(np.flatnonzero((first & TVS.LUT_L2) == 0)[-1])
    long_slot = int(np.flatnonzero(first & TVS.LUT_L2)[0])
    lut[bases["MOTION"] + 5] = 12345
    lut[bases["DCT_NEXT"] + slot * lo:][:lo] = 777
    lut[bases["DCT_NEXT"] + long_slot * lo + 3] = 4242
    assert np.array_equal(expand_compact_lut(TVS.compact_lut(lut).numpy()),
                          lut.numpy())
