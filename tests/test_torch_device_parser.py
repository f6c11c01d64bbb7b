"""The device parser: the port's sequential scan and decode vs the JAX package.

Same numpy inputs (make_picture_batch of encoder pictures) go through
espflix_tpu.ops.vlc_scan.run_scan (initial_state, the XLA while loop)
and the port's vlc_scan.run_scan (K1S's plain form): coefficients,
records, EOB counts, the lane error flag and the step count are equal
on clean I / P pictures of several slices, an idle lane, a corrupt
picture (an invalid macroblock type), a picture cut at the symbol
budget (one step short of and exactly at what it needs) and a picture
whose payload is cut short so the scan runs past the lane's words.
Then models/mpeg1.decode_picture_batch (K1S + K2F + K3F plain forms)
against the JAX decode_picture_batch over three pictures with the frame
state carried: frames, parity, presented planes and info, sequential
and slice-parallel (a scan row a slice).  Last, the
port's Fleet(parser="device") against the JAX one on the same service
(tests/torch_fleet.py): four lanes with three sessions and a corrupt
picture, two ticks and a run_chunk of two -- every TickResult field,
the carries, the sessions and the events.
"""

import dataclasses

import numpy as np
import pytest
import torch

from espflix_tpu_torch.models import mpeg1 as TM
from espflix_tpu_torch.ops import vlc_scan as TVS
from espflix_tpu_torch.tools import mpeg1_encode as TE
from espflix_tpu_torch.tools.serve_scenario import corrupt_picture, \
    corrupt_slice

try:
    import jax.numpy as jnp
    from espflix_tpu.models import mpeg1 as JM
    from espflix_tpu.ops import vlc_scan as JVS
    from tests import torch_fleet as TF
except ImportError:     # the card's machine has no jax: gpu tests only
    jnp = JM = JVS = TF = None

torch.set_num_threads(1)

KEYS = ("words", "slice_starts", "slice_rows", "n_slices", "pic_type",
        "full_pel", "r_size")


def _pictures(seed, n_pictures=3, width=96, height=64):
    rng = np.random.default_rng(seed)
    es = TE.encode_es(TE.random_script(rng, n_pictures=n_pictures,
                                       max_coeffs=10, width=width,
                                       height=height))
    return TM.parse_es(es)[1]


def _jax_scan(b, max_steps, max_symbols=20000):
    mbw, mbh = b["mb_width"], b["mb_height"]
    N = len(b["active"])
    st0 = JVS.initial_state(N, *(jnp.asarray(b[k]) for k in KEYS[1:]))
    coeffs, recs, nfinal, st, iters = JVS.run_scan(
        jnp.asarray(b["words"]), st0, mbw, mbw * mbh, max_steps,
        max_symbols=max_symbols)
    err = np.asarray(st["error"]) | (np.asarray(st["state"])
                                     != JVS.ST_DONE)
    return [np.asarray(a) for a in (coeffs, recs, nfinal)] + [
        err, int(iters)]


def _port_scan(b, max_steps, max_symbols=20000):
    tables = TM.decode_tables("cpu")
    x = TM.xs_to_torch({k: b[k] for k in KEYS}, "cpu")
    out = TVS.run_scan(*x.values(), mb_width=b["mb_width"],
                       mb_height=b["mb_height"], max_steps=max_steps,
                       max_symbols=max_symbols, lut=tables["lut"],
                       zigzag=tables["zigzag"])
    return [t.numpy() for t in out[:4]] + [int(out[4])]


def _assert_scans_equal(j, t):
    for name, a, b in zip(("coeffs", "recs", "nfinal", "err"), j, t):
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert j[4] == t[4], ("iters", j[4], t[4])


def test_run_scan_matches_jax_on_clean_pictures():
    """I and P pictures of several slices on four lanes, one lane idle."""
    pics = _pictures(1)
    b = TM.make_picture_batch([pics[0], pics[1], None, pics[2]],
                              max_slices=4)
    assert (b["n_slices"][[0, 1, 3]] > 1).all()
    assert set(b["pic_type"][[0, 1, 3]]) == {1, 2}
    j = _jax_scan(b, 4096)
    _assert_scans_equal(j, _port_scan(b, 4096))
    assert not j[3].any() and j[4] > 0


def test_run_scan_matches_jax_on_a_corrupt_picture():
    """serve_scenario's corrupt I picture errors its lane at its first
    macroblock; a clean lane beside it is unaffected."""
    bad = corrupt_picture()
    b = TM.make_picture_batch([bad, None], max_slices=12)
    j = _jax_scan(b, 2048)
    _assert_scans_equal(j, _port_scan(b, 2048))
    assert j[3][0] and not j[3][1]


@pytest.mark.parametrize("short", [1, 0])
def test_run_scan_matches_jax_at_the_budget(short):
    """A picture given one step fewer than it needs errors (still
    scanning at the budget), with the emissions of the steps it took;
    given exactly what it needs it does not.  The budget is
    min(max_steps, max_symbols), so it is cut through either."""
    pics = _pictures(2)
    b = TM.make_picture_batch([pics[0], pics[1]], max_slices=4)
    need = _jax_scan(b, 4096)[4]
    for ms, sym in ((need - short, 20000), (4096, need - short)):
        j = _jax_scan(b, ms, sym)
        _assert_scans_equal(j, _port_scan(b, ms, sym))
        assert j[3].any() == bool(short) and j[4] == need - short


def test_run_scan_matches_jax_past_the_words():
    """A payload cut short: the scan reads past the lane's words, where
    the XLA gather reads 0xFFFFFFFF."""
    pics = _pictures(3)
    b = TM.make_picture_batch([pics[0], pics[1]], max_slices=4)
    b["words"] = np.ascontiguousarray(
        b["words"][:, :int(b["n_words"].min()) // 2])
    j = _jax_scan(b, 3000)
    _assert_scans_equal(j, _port_scan(b, 3000))
    assert j[3].all()


@pytest.mark.parametrize("seed", [4, 5])
def test_decode_picture_batch_matches_jax(seed):
    """Three pictures decoded in turn with the frame state carried,
    from random frames and parities; lane 2 idle on the second."""
    _decode_both(seed, slice_parallel=False)


def _decode_both(seed, slice_parallel):
    pics = _pictures(seed)
    N = 3
    mbw, mbh = pics[0].seq.mb_width, pics[0].seq.mb_height
    wpl = max((len(p.payload) + 3) // 4 + 4 for p in pics)
    rng = np.random.default_rng(seed)
    frames = {k: rng.integers(0, 249, (N, 2) + (
        (mbh * 16, mbw * 16) if k == "y" else (mbh * 8, mbw * 8)),
        dtype=np.uint8) for k in "yuv"}
    frames["parity"] = rng.integers(0, 2, N).astype(np.int32)
    jf = {k: jnp.asarray(v) for k, v in frames.items()}
    tf = {k: torch.from_numpy(v.copy()) for k, v in frames.items()}
    tables = TM.decode_tables("cpu")
    for t, p in enumerate(pics):
        sel = [p, p, None if t == 1 else p]
        b = TM.make_picture_batch(sel, words_per_lane=wpl, max_slices=mbh)
        jf, jp, ji = JM.decode_picture_batch(
            *(jnp.asarray(b[k]) for k in TM.PICTURE_KEYS), jf,
            mb_width=mbw, mb_height=mbh, max_steps=wpl * 32,
            slice_parallel=slice_parallel)
        x = TM.xs_to_torch({k: b[k] for k in TM.PICTURE_KEYS}, "cpu")
        tf, tp, ti = TM.decode_picture_batch(
            *x.values(), tf, mb_width=mbw, mb_height=mbh,
            max_steps=wpl * 32, slice_parallel=slice_parallel,
            tables=tables)
        for k in ("y", "u", "v", "parity"):
            assert np.array_equal(tf[k].numpy(), np.asarray(jf[k])), (t, k)
        for k in "yuv":
            assert np.array_equal(tp[k].numpy(), np.asarray(jp[k])), (t, k)
        for k in ("error", "ok", "iters"):
            a, c = ti[k].numpy(), np.asarray(ji[k])
            assert a.dtype == c.dtype and np.array_equal(a, c), (t, k)
        assert not ti["error"].any()


def test_slice_parallel_is_not_ported():
    """slice_parallel=True (one scan row a slice; once refused by the
    port) decodes as the JAX one over the same three pictures: frames,
    parity, planes, and error / ok / iters with their dtypes."""
    _decode_both(4, slice_parallel=True)


@pytest.mark.gpu
def test_seq_kernel_matches_plain_on_card():
    """K1S against its plain form on the card: clean pictures, an idle
    lane, the corrupt picture, a corrupt slice in the middle of a
    picture, two slices on one MB row, and budgets that cut lanes inside
    slice 0 and inside a later slice; then the reports of its per-slice
    pass against scan_slices_torch, and its second pass's resolution
    against resolve_slices."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pics = _pictures(6, width=352, height=192, n_pictures=2)
    p = pics[0]
    dup = dataclasses.replace(
        p, slice_offsets=[p.slice_offsets[0]] + p.slice_offsets,
        slice_rows=[p.slice_rows[0]] + p.slice_rows)
    b = TM.make_picture_batch(pics + [None, corrupt_picture(), p, dup],
                              max_slices=13)
    corrupt_slice(b, 4, 5)
    kw = dict(mb_width=22, mb_height=12)
    for ms in (12000, 3000, 700):
        outs = []
        for dev in ("cpu", "cuda"):
            tables = TM.decode_tables(dev)
            x = TM.xs_to_torch({k: b[k] for k in KEYS}, dev)
            outs.append([t.cpu() for t in TVS.run_scan(
                *x.values(), max_steps=ms, lut=tables["lut"],
                zigzag=tables["zigzag"], **kw)])
        for a, c in zip(*outs):
            assert torch.equal(a, c), ms
    counts = []
    for dev, fn in (("cpu", TVS.scan_slices_torch),
                    ("cuda", TVS.scan_slices_cuda)):
        tables = TM.decode_tables(dev)
        x = TM.xs_to_torch({k: b[k] for k in KEYS}, dev)
        kwd = dict(kw, budget=3000, lut=tables["lut"],
                   zigzag=tables["zigzag"])
        parts = fn(*x.values(), **kwd)
        counts.append([t.cpu() for t in parts[3:]])
    for a, c in zip(*counts):
        assert torch.equal(a, c)
    err, lane_steps, redo = TVS.resolve_slices(*counts[0], x["n_slices"].cpu(),
                                               3000)
    fin = TVS.finish_slices_cuda(*x.values(), *parts, **kwd)
    assert torch.equal(fin[3].cpu(), err) and torch.equal(fin[5].cpu(), redo)
    assert int(fin[4]) == int(lane_steps.max()) and redo.any()


# ---- Fleet(parser="device") ----------------------------------------------

@pytest.fixture(scope="module")
def device_fleets(tmp_path_factory):
    url = TF.make_service(tmp_path_factory, "svc_device")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ESPFLIX_NATIVE_FEED", "0")
        return TF.run_both(url, TF.ticks_then_chunk, n=4, lanes=(0, 1, 3),
                           corrupt_lane=1, seed=9, parser="device")


@pytest.mark.parametrize("key", TF.RESULT_KEYS if TF else ())
def test_device_fleet_results_match(device_fleets, key):
    _jf, jr, _tf, tr = device_fleets
    TF.assert_results_equal(jr, tr, key)


def test_device_fleet_carries_match(device_fleets):
    """Frames, parity, SBC history, sessions and events; the corrupt
    picture errors lane 1 once and every session presents."""
    jf, _jr, tf, tr = device_fleets
    TF.assert_carries_equal(jf, tf)
    errs = np.stack([r.errors for r in tr])
    assert errs[:, 1].sum() == 1 and not errs[:, [0, 2, 3]].any()
    vl = np.stack([r.video_lanes for r in tr])
    assert vl[:, [0, 1, 3]].any(axis=0).all()


def test_hybrid_parser_is_not_ported():
    """The hybrid parser is ported now: Fleet(parser="hybrid") decodes a
    tick of one lane, or, without the tokenizer library, falls back to
    the device parser as the JAX Fleet does (scheduler.py:160-163).
    tests/test_torch_hybrid.py holds it equal to the JAX fleet."""
    from types import SimpleNamespace

    from espflix_tpu_torch.runtime.player import State
    from espflix_tpu_torch.runtime.scheduler import Fleet
    from espflix_tpu_torch.tools import oracle
    fleet = Fleet(1, width=96, height=64, parser="hybrid", device="cpu")
    assert fleet.parser == ("hybrid" if oracle.available() else "device")
    pic = _pictures(4, n_pictures=1)[0]
    presented = []
    fleet.attach(0, SimpleNamespace(
        state=State.PAUSED, feed=None, clock=SimpleNamespace(
            tick=lambda: None), next_picture=lambda: pic,
        on_presented=presented.append))
    r = fleet.tick(decode_audio=False)
    assert r.video_lanes.tolist() == [True] and not r.errors.any()
    assert presented == [pic.pts] and r.y.shape == (1, 64, 96)
    assert r.y.any()
