"""The validation path: models/mpeg1.decode_es_batched and
decode_picture_impl(slice_parallel=True), against the JAX package and
against the port's own C oracle binding (tools/oracle.decode_mpeg1).

decode_es_batched decodes whole streams in lock-step with one word
window and slice count for the run and the batch's bit count as the
budget: on 96x64 lanes of unequal length (starved lanes present
nothing) its frames equal the JAX function's and the golden decoder's,
sequential and slice-parallel, and a corrupt slice raises the same
ValueError as the JAX function.  One 352x192 lane is held to the oracle
through the slice-parallel decode (the plain sequential scan takes ~7 s
a picture there).

slice_parallel=True scans every slice as its own row (K1S's per-slice
pass; scan_slices_torch here).  Two pictures of six lanes at a budget
of 700 steps: clean I and P pictures, an idle lane, a corrupt slice, a
slice given twice (two slices on one MB row) and, in the first picture,
one slice the budget cuts.  Planes, error, ok and iters (with dtypes)
equal the JAX decode's; the doubled slice's lane is held on its flags
alone, as the MB both slices claim has no defined value.

The `gpu` tests run both on the card at 352x192: the slice-parallel
decode launches the per-slice pass alone, and decode_es_batched equals
the oracle in both modes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from espflix_tpu_torch.models import mpeg1 as TM
from espflix_tpu_torch.ops import vlc_scan as TVS
from espflix_tpu_torch.tools import mpeg1_encode as TE
from espflix_tpu_torch.tools import oracle
from espflix_tpu_torch.tools.content import realistic_gop_script
from espflix_tpu_torch.tools.serve_scenario import BAD_SLICE, corrupt_slice

try:
    import jax.numpy as jnp
    from espflix_tpu.models import mpeg1 as JM
except ImportError:     # the card's machine has no jax: gpu tests only
    jnp = JM = None

torch.set_num_threads(1)

SMALL = dict(width=96, height=64)


def _es(seed, n_pictures, max_coeffs=10):
    rng = np.random.default_rng(seed)
    return TE.encode_es(TE.random_script(rng, n_pictures=n_pictures,
                                         max_coeffs=max_coeffs, **SMALL))


def _corrupt(es: bytes, picture: int, k: int) -> bytes:
    """es with slice k of picture `picture` opening on BAD_SLICE's
    invalid macroblock type (its low bytes 0xFF, so no start code is
    emulated)."""
    codes = TM.find_start_codes(es)
    pic_at = [pos for pos, code in codes if code == 0][picture]
    off = [pos for pos, code in codes
           if pos > pic_at and 1 <= code <= 0xAF][k] + 4
    bad = (BAD_SLICE | 0xFFFF).to_bytes(4, "big")
    return es[:off] + bad + es[off + 4:]


def _assert_frames(got, want, label):
    assert len(got) == len(want), label
    for k, (g, w) in enumerate(zip(got, want)):
        for c, a, b in zip("yuv", g, w):
            assert a.dtype == b.dtype == np.uint8, (label, k, c)
            assert np.array_equal(a, b), (label, k, c)


@pytest.fixture(scope="module")
def streams():
    return [_es(44, 4), _es(45, 2), _es(46, 3)]


@pytest.fixture(scope="module")
def jax_frames(streams):
    return JM.decode_es_batched(streams)


@pytest.mark.parametrize("slice_parallel", [False, True],
                         ids=["sequential", "slice_parallel"])
def test_decode_es_batched_matches_jax_and_oracle(streams, jax_frames,
                                                  slice_parallel):
    got = TM.decode_es_batched(streams, slice_parallel=slice_parallel,
                               device="cpu")
    assert [len(o) for o in got] == [4, 2, 3]
    for lane, es in enumerate(streams):
        _assert_frames(got[lane], jax_frames[lane], ("jax", lane))
        want, _pts = oracle.decode_mpeg1(es, **SMALL)
        _assert_frames(got[lane], want, ("oracle", lane))


def test_decode_es_batched_raises_like_jax(streams):
    bad = [streams[0], _corrupt(streams[1], 1, 2), streams[2]]
    with pytest.raises(ValueError) as jerr:
        JM.decode_es_batched(bad)
    for slice_parallel in (False, True):
        with pytest.raises(ValueError) as terr:
            TM.decode_es_batched(bad, slice_parallel=slice_parallel,
                                 device="cpu")
        assert str(terr.value) == str(jerr.value) == \
            "picture 1: lane decode errors at [1]"
    out = TM.decode_es_batched(bad, check_errors=False, slice_parallel=True,
                               device="cpu")
    assert [len(o) for o in out] == [4, 2, 3]


def test_decode_es_batched_352x192_lane_matches_oracle():
    es = TE.encode_es(realistic_gop_script(np.random.default_rng(1000),
                                           n_pictures=2))
    got = TM.decode_es_batched([es], slice_parallel=True, device="cpu")
    want, _pts = oracle.decode_mpeg1(es)
    _assert_frames(got[0], want, "352x192")


def test_decode_mpeg1_rejects_other_dimensions(streams):
    with pytest.raises(ValueError, match="not 352x192"):
        oracle.decode_mpeg1(streams[0])


# ---- slice_parallel=True against the JAX decode ---------------------------

BUDGET = 700
IDLE, CORRUPT, DOUBLED, LONG = 2, 3, 4, 5


def _doubled(p):
    return dataclasses.replace(
        p, slice_offsets=[p.slice_offsets[0]] + p.slice_offsets,
        slice_rows=[p.slice_rows[0]] + p.slice_rows)


def _batches():
    """Two pictures (I, then P) of six lanes: two clean streams, an
    idle lane, a corrupt slice 2, slice 0 given twice, and a stream of
    long slices of which the first picture's slice 0 (714 steps) is the
    only one past BUDGET."""
    a, b, c = (TM.parse_es(_es(seed, 2, mc))[1]
               for seed, mc in ((1, 10), (2, 10), (7, 30)))
    out = []
    for k in range(2):
        batch = TM.make_picture_batch(
            [a[k], b[k], None, a[k], _doubled(a[k]), c[k]],
            words_per_lane=1200, max_slices=5)
        corrupt_slice(batch, CORRUPT, 2)
        out.append(batch)
    return out


@pytest.fixture(scope="module")
def slice_parallel_runs():
    tables = TM.decode_tables("cpu")
    jf = JM.init_frame_state(6, 96, 64)
    tf = TM.init_frame_state(6, 96, 64, "cpu")
    runs = []
    for b in _batches():
        jf, jp, ji = JM.decode_picture_batch(
            *(jnp.asarray(b[k]) for k in TM.PICTURE_KEYS), jf, mb_width=6,
            mb_height=4, max_steps=BUDGET, max_symbols=BUDGET,
            slice_parallel=True)
        x = TM.xs_to_torch({k: b[k] for k in TM.PICTURE_KEYS}, "cpu")
        steps = TVS.scan_slices_torch(
            *list(x.values())[:7], mb_width=6, mb_height=4, budget=BUDGET,
            lut=tables["lut"], zigzag=tables["zigzag"])[3]
        tf, tp, ti = TM.decode_picture_batch(
            *x.values(), tf, mb_width=6, mb_height=4, max_steps=BUDGET,
            max_symbols=BUDGET, slice_parallel=True, tables=tables)
        runs.append(dict(
            jax=(dict(jp), dict(ji), dict(jf)),
            port=(dict(tp), dict(ti), {k: t.clone() for k, t in tf.items()}),
            steps=steps.numpy()))
    return runs


@pytest.mark.parametrize("picture", [0, 1])
def test_slice_parallel_flags_match_jax(slice_parallel_runs, picture):
    r = slice_parallel_runs[picture]
    (_jp, ji, _jf), (_tp, ti, _tf) = r["jax"], r["port"]
    for k in ("error", "ok", "iters"):
        a, c = ti[k].numpy(), np.asarray(ji[k])
        assert a.dtype == c.dtype and np.array_equal(a, c), k
    err = ti["error"].numpy()
    assert err[CORRUPT] and not err[[0, 1, IDLE, DOUBLED]].any()
    # the cut slice errors its lane; iters is the longest row's steps,
    # the budget where a slice is cut
    assert err[LONG] == (picture == 0)
    steps = r["steps"]
    assert (steps[LONG, 0] == BUDGET) == (picture == 0)
    assert set(ti["iters"].tolist()) == {min(BUDGET, int(steps.max()))}
    assert not ti["ok"].numpy()[IDLE]


@pytest.mark.parametrize("picture", [0, 1])
def test_slice_parallel_planes_match_jax(slice_parallel_runs, picture):
    r = slice_parallel_runs[picture]
    (jp, _ji, jf), (tp, _ti, tf) = r["jax"], r["port"]
    lanes = [i for i in range(6) if i != DOUBLED]
    for k in "yuv":
        assert np.array_equal(tp[k].numpy()[lanes],
                              np.asarray(jp[k])[lanes]), k
        assert np.array_equal(tf[k].numpy()[lanes],
                              np.asarray(jf[k])[lanes]), k
    assert np.array_equal(tf["parity"].numpy(), np.asarray(jf["parity"]))


# ---- on the card -----------------------------------------------------------

def _card_streams(n):
    return [TE.encode_es(realistic_gop_script(np.random.default_rng(s),
                                              n_pictures=2 + s % 2))
            for s in range(n)]


@pytest.mark.gpu
def test_slice_parallel_on_card_launches_the_per_slice_pass_alone():
    """352x192 I and P pictures on 8 lanes, one starved: the card's
    slice-parallel decode equals the plain one (planes, error, ok,
    iters) and launches K1S once a picture -- the per-slice pass, never
    the second -- then K2F and K3F."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from espflix_tpu_torch.ops import idct, mocomp

    pics = [TM.parse_es(es)[1] for es in _card_streams(8)]
    outs = []
    for dev in ("cpu", "cuda"):
        frames = TM.init_frame_state(8, 352, 192, dev)
        tables = TM.decode_tables(dev)
        got = []
        for k in range(3):
            b = TM.make_picture_batch(
                [p[k] if k < len(p) else None for p in pics],
                words_per_lane=12000, max_slices=12)
            x = TM.xs_to_torch({key: b[key] for key in TM.PICTURE_KEYS}, dev)
            counts = (TVS.launches_seq, idct.launches_flat,
                      mocomp.launches_flat)
            frames, pres, info = TM.decode_picture_batch(
                *x.values(), frames, mb_width=22, mb_height=12,
                max_steps=384000, max_symbols=384000, slice_parallel=True,
                tables=tables)
            if dev == "cuda":
                assert (TVS.launches_seq, idct.launches_flat,
                        mocomp.launches_flat) == tuple(c + 1 for c in counts)
            got.append([pres[c].cpu() for c in "yuv"]
                       + [info[c].cpu() for c in ("error", "ok", "iters")])
        outs.append(got)
    for k, (a, c) in enumerate(zip(*outs)):
        for name, s, t in zip(("y", "u", "v", "error", "ok", "iters"), a, c):
            assert torch.equal(s, t), (k, name)


@pytest.mark.gpu
@pytest.mark.parametrize("slice_parallel", [False, True],
                         ids=["sequential", "slice_parallel"])
def test_decode_es_batched_on_card_matches_oracle(slice_parallel):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    streams = _card_streams(6)
    got = TM.decode_es_batched(streams, slice_parallel=slice_parallel,
                               device="cuda")
    for lane, es in enumerate(streams):
        _assert_frames(got[lane], oracle.decode_mpeg1(es)[0], lane)
